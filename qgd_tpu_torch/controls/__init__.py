"""Control pulses (counterpart of ``qgd_tpu.controls``): the protocol, the
quadratic B-spline, GRAPE and carrier-wave families."""

from .base import (
    Control,
    as_control_tuple,
    total_control_parameters,
    control_vector_slice,
    control_tables,
    control_tables_at,
)
from .bspline import BSpline2Control
from .analytic import GRAPEControl, GeneralGRAPEControl
from .carrier import CarrierControl

__all__ = [
    "Control",
    "as_control_tuple",
    "total_control_parameters",
    "control_vector_slice",
    "control_tables",
    "control_tables_at",
    "BSpline2Control",
    "GRAPEControl",
    "GeneralGRAPEControl",
    "CarrierControl",
]
