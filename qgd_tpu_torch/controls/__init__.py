"""Control pulses (counterpart of ``qgd_tpu.controls``): the protocol and
the quadratic B-spline family."""

from .base import (
    Control,
    as_control_tuple,
    total_control_parameters,
    control_vector_slice,
    control_tables,
    control_tables_at,
)
from .bspline import BSpline2Control

__all__ = [
    "Control",
    "as_control_tuple",
    "total_control_parameters",
    "control_vector_slice",
    "control_tables",
    "control_tables_at",
    "BSpline2Control",
]
