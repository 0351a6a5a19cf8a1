"""Numerical core: Hermite recursion, stage solvers and the CUDA stage
kernels."""

from .hermite import (
    hermite_coefficient,
    hermite_coefficients,
    assemble_generator_stack,
    scaled_derivatives,
    build_rhs,
    build_lhs,
)
from .linalg import (
    REFINE_SWEEPS_F32,
    factorize_stages,
    solve_factored,
    stage_solve,
    stage_solve_transposed,
    schulz_inverse,
    schulz_universal_init,
    schulz_warm_iters,
    schulz_inverse_auto,
    inverse_stage_solve,
)
from .stage_kernels import (
    hermite_lhs_matrix_kernel_call,
    hermite_rhs_kernel_call,
    lhs_matrix_plain,
    rhs_plain,
    reset_launch_counts,
    launch_counts,
)

__all__ = [
    "hermite_coefficient",
    "hermite_coefficients",
    "assemble_generator_stack",
    "scaled_derivatives",
    "build_rhs",
    "build_lhs",
    "REFINE_SWEEPS_F32",
    "factorize_stages",
    "solve_factored",
    "stage_solve",
    "stage_solve_transposed",
    "schulz_inverse",
    "schulz_universal_init",
    "schulz_warm_iters",
    "schulz_inverse_auto",
    "inverse_stage_solve",
    "hermite_lhs_matrix_kernel_call",
    "hermite_rhs_kernel_call",
    "lhs_matrix_plain",
    "rhs_plain",
    "reset_launch_counts",
    "launch_counts",
]
