"""Native (C++) de Boor B-spline basis evaluation with derivatives, the
port's own copy (counterpart of ``qgd_tpu.native``), built with g++ at
first use and bound with ctypes."""

from .binding import (
    bsplvb,
    bsplvd,
    bspline_tables,
    native_available,
    build_library,
)

__all__ = ["bsplvb", "bsplvd", "bspline_tables", "native_available",
           "build_library"]
