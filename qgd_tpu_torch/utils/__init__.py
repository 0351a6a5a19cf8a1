"""Analysis and verification utilities (counterpart of
``qgd_tpu.utils``): state helpers, timestep estimation, the Richardson
convergence and timing harness, the scipy/QuTiP ground truth
(``ode_check``) and plotting (``plotting``, ``visualizer``, which import
matplotlib on use)."""

from .states import (
    get_populations,
    target_helper,
    complex_to_real,
    real_to_complex,
    initial_basis,
)
from .timestep import (
    get_shortest_period,
    estimate_N_timesteps,
    estimate_timesteps_per_period,
)
from .richardson import (
    richardson_extrap_sol,
    richardson_extrap_rel_err,
    get_histories,
    get_runtime_ratios,
    find_target_y,
)

__all__ = [
    "get_populations",
    "target_helper",
    "complex_to_real",
    "real_to_complex",
    "initial_basis",
    "get_shortest_period",
    "estimate_N_timesteps",
    "estimate_timesteps_per_period",
    "richardson_extrap_sol",
    "richardson_extrap_rel_err",
    "get_histories",
    "get_runtime_ratios",
    "find_target_y",
]
