"""Control pulses (counterpart of ``qgd_tpu.controls``): the protocol and
every family of the JAX package: quadratic and de Boor B-splines, GRAPE,
carrier waves, Hermite interpolants and the analytic test families."""

from .base import (
    Control,
    as_control_tuple,
    total_control_parameters,
    control_vector_slice,
    local_control_index,
    control_tables,
    control_tables_at,
    taylor_coefficients,
    eval_p,
    eval_q,
    eval_p_derivative,
    eval_q_derivative,
    eval_grad_p_derivative,
    eval_grad_q_derivative,
)
from .bspline import BSpline2Control
from .analytic import (
    SinCosControl,
    SinControl,
    CosControl,
    SquaredAmpCosControl,
    SingleSymCosControl,
    ZeroControl,
    GRAPEControl,
    GeneralGRAPEControl,
)
from .carrier import CarrierControl
from .deboor import GeneralBSplineControl, FortranBSplineControl
from .hermite import HermiteControl, HermiteCarrierControl


def BSplineControl(tf, D1, omega):
    """B-spline-times-carrier control:
    ``CarrierControl(BSpline2Control(D1, tf), omega)``, one ``2*D1``
    B-spline block per carrier frequency."""
    return CarrierControl(BSpline2Control(D1, tf), omega)


__all__ = [
    "Control",
    "as_control_tuple",
    "total_control_parameters",
    "control_vector_slice",
    "local_control_index",
    "control_tables",
    "control_tables_at",
    "taylor_coefficients",
    "eval_p",
    "eval_q",
    "eval_p_derivative",
    "eval_q_derivative",
    "eval_grad_p_derivative",
    "eval_grad_q_derivative",
    "BSpline2Control",
    "BSplineControl",
    "SinCosControl",
    "SinControl",
    "CosControl",
    "SquaredAmpCosControl",
    "SingleSymCosControl",
    "ZeroControl",
    "GRAPEControl",
    "GeneralGRAPEControl",
    "CarrierControl",
    "GeneralBSplineControl",
    "FortranBSplineControl",
    "HermiteControl",
    "HermiteCarrierControl",
]
