"""qgd_tpu_torch — the PyTorch/CUDA port of ``qgd_tpu`` (quantum optimal
control, gate design), for NVIDIA Hopper.

What is ported: gate design end to end. The optimizer drivers
(``optimize_gate``: scipy L-BFGS-B on the host or L-BFGS on the device;
``optimize_gate_multistart``, batched L-BFGS on the device), the plain
Lagrange route (forward history, thinned or whole, adjoint sweep,
``objective_and_gradient``, ``discrete_adjoint``), the segmented route at
any segment length (its step loops run as programs captured once as CUDA
graphs and replayed), its host-chunked form for long horizons and the
prefix-product latency route, each with the
``"lu"`` and ``"schulz"`` stage solvers and the matrix-free ``"gmres"``
solver with its three preconditioners (``parallel.tp_forward_history``
shards its levels over a process group), the forced, finite-difference
and Hessian checks, the objective API, every control family with its own
native de Boor library, every problem builder of the JAX package, setup
checkpoints and the stage-residual diagnostic, scenario and gate-column
sharding over ``torch.distributed`` (``parallel``: every gradient route
takes an ``ic_group`` to sum the column reductions over), the Juqbox
interchange and Stormer-Verlet baseline, and the analysis utilities
(``utils``: state helpers, timestep estimates, the Richardson harness,
the scipy/QuTiP ground truth, plotting). Control vectors are
batched as a leading tensor dimension. The two Pallas kernels of
``qgd_tpu/ops/pallas_step.py`` are hand-written CUDA kernels here
(``csrc/lhs.cuh``, ``csrc/rhs.cu``, wrapped in ``ops/stage_kernels.py``),
the LHS one also in the variant that builds the adjoint's pair of
one-step matrices (``csrc/pair.cu``; at order 4 a split-TF32 tensor-core
kernel, ``csrc/pair_tf32.cuh``),
built with ``nvcc`` at first use on a CUDA tensor. Problems are built on
the card unless the caller passes ``device="cpu"``.

The package imports torch and numpy, never JAX.
"""

import torch as _torch

# Full-precision float32 matmuls, pinned once at import. TF32 keeps ~10
# mantissa bits: in the implicit stage solves that is the same kind of
# per-step bias that single-pass bf16 matmuls gave on the TPU, where it
# made long-horizon propagation unstable.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .problem import (  # noqa: E402
    SchrodingerProblem,
    schrodinger_problem,
    schrodinger_problem_complex,
    problem_from_arrays,
    working_problem,
    vector_problem,
)
from .ops.hermite import (  # noqa: E402
    hermite_coefficient,
    hermite_coefficients,
    assemble_generator_stack,
    scaled_derivatives,
    build_rhs,
    build_lhs,
    adjoint_scaled_derivatives,
    taylor_expand,
    form_lhs_matrix,
    form_rhs_matrix,
)
from .controls import (  # noqa: E402
    Control,
    BSpline2Control,
    BSplineControl,
    GRAPEControl,
    GeneralGRAPEControl,
    CarrierControl,
    SinCosControl,
    SinControl,
    CosControl,
    SquaredAmpCosControl,
    SingleSymCosControl,
    ZeroControl,
    GeneralBSplineControl,
    FortranBSplineControl,
    HermiteControl,
    HermiteCarrierControl,
    control_tables,
    control_tables_at,
    total_control_parameters,
    control_vector_slice,
    eval_p,
    eval_q,
    eval_p_derivative,
    eval_q_derivative,
    eval_grad_p_derivative,
    eval_grad_q_derivative,
)
from .objective import (  # noqa: E402
    infidelity_real,
    infidelity,
    guard_penalty_real,
    guard_penalty,
    terminal_cost,
    terminal_cost_and_grad,
    host_realify_target,
    objective_parts,
    objective_value,
    infidelity_plus_guard,
)
from .forward import (  # noqa: E402
    hermite_forward_history,
    eval_forward,
    eval_forward_complex,
    eval_adjoint,
)
from .adjoint import (  # noqa: E402
    discrete_adjoint,
    compute_guard_forcing,
    compute_terminal_condition,
    objective_and_gradient,
    eval_grad_forced,
    eval_grad_finite_difference,
    eval_hessian,
)
from .segmented import (  # noqa: E402
    SegmentGraphs,
    choose_segments,
    segmented_objective_and_gradient,
    segmented_gradient,
    segmented_objective_value,
)
from .chunked import chunked_objective_and_gradient  # noqa: E402
from .prefix import (  # noqa: E402
    prefix_objective_and_gradient,
    prefix_objective_value,
    eval_forward_prefix,
)
from .optimize import (  # noqa: E402
    OptimizationHistory,
    optimize_gate,
    optimize_gate_multistart,
    gradient_descent,
)
from .checkpoint import (  # noqa: E402
    save_setup,
    load_setup,
    resume_optimization,
    verify_history_f64,
)
from .diagnostics import stage_residuals  # noqa: E402
from . import models  # noqa: E402
from .models import (  # noqa: E402
    construct_rabi_prob,
    construct_rand_prob,
    dahlquist_problem,
    rotating_frame_qubit,
    DispersiveProblem,
    JaynesCummingsProblem,
    multi_qudit_hamiltonian_dispersive,
    multi_qudit_hamiltonian_jayne,
    control_ops,
    lowering_operator_subsystem,
    lowering_operator,
    lowering_operators_system,
    basis_state,
    create_initial_conditions,
    create_gate,
    guard_projector,
    rotation_matrix,
    cnot3_problem,
    cnot3_carrier_frequencies,
    cnot3_target,
    cnot2_problem,
    convert_juqbox,
    convert_to_juqbox,
    load_juqbox_npz,
)
from .controls.hermite import (  # noqa: E402
    sample_from_controls,
    construct_pcof_from_sample,
)
from . import parallel  # noqa: E402
from . import native  # noqa: E402
from . import utils  # noqa: E402
from .utils import (  # noqa: E402
    get_populations,
    target_helper,
    complex_to_real,
    real_to_complex,
    initial_basis,
    get_shortest_period,
    estimate_N_timesteps,
    estimate_timesteps_per_period,
    richardson_extrap_sol,
    richardson_extrap_rel_err,
    get_histories,
    get_runtime_ratios,
)

__version__ = "0.1.0"

__all__ = [
    "SchrodingerProblem",
    "schrodinger_problem",
    "schrodinger_problem_complex",
    "problem_from_arrays",
    "working_problem",
    "vector_problem",
    "hermite_coefficient",
    "hermite_coefficients",
    "assemble_generator_stack",
    "scaled_derivatives",
    "build_rhs",
    "build_lhs",
    "adjoint_scaled_derivatives",
    "taylor_expand",
    "form_lhs_matrix",
    "form_rhs_matrix",
    "Control",
    "BSpline2Control",
    "BSplineControl",
    "GRAPEControl",
    "GeneralGRAPEControl",
    "CarrierControl",
    "SinCosControl",
    "SinControl",
    "CosControl",
    "SquaredAmpCosControl",
    "SingleSymCosControl",
    "ZeroControl",
    "GeneralBSplineControl",
    "FortranBSplineControl",
    "HermiteControl",
    "HermiteCarrierControl",
    "control_tables",
    "control_tables_at",
    "total_control_parameters",
    "control_vector_slice",
    "eval_p",
    "eval_q",
    "eval_p_derivative",
    "eval_q_derivative",
    "eval_grad_p_derivative",
    "eval_grad_q_derivative",
    "infidelity_real",
    "infidelity",
    "guard_penalty_real",
    "guard_penalty",
    "terminal_cost",
    "terminal_cost_and_grad",
    "host_realify_target",
    "objective_parts",
    "objective_value",
    "infidelity_plus_guard",
    "hermite_forward_history",
    "eval_forward",
    "eval_forward_complex",
    "eval_adjoint",
    "discrete_adjoint",
    "compute_guard_forcing",
    "compute_terminal_condition",
    "objective_and_gradient",
    "eval_grad_forced",
    "eval_grad_finite_difference",
    "eval_hessian",
    "choose_segments",
    "segmented_objective_and_gradient",
    "SegmentGraphs",
    "segmented_gradient",
    "segmented_objective_value",
    "chunked_objective_and_gradient",
    "prefix_objective_and_gradient",
    "prefix_objective_value",
    "eval_forward_prefix",
    "OptimizationHistory",
    "optimize_gate",
    "optimize_gate_multistart",
    "gradient_descent",
    "save_setup",
    "load_setup",
    "resume_optimization",
    "verify_history_f64",
    "stage_residuals",
    "models",
    "construct_rabi_prob",
    "construct_rand_prob",
    "dahlquist_problem",
    "rotating_frame_qubit",
    "DispersiveProblem",
    "JaynesCummingsProblem",
    "multi_qudit_hamiltonian_dispersive",
    "multi_qudit_hamiltonian_jayne",
    "control_ops",
    "lowering_operator_subsystem",
    "lowering_operator",
    "lowering_operators_system",
    "basis_state",
    "create_initial_conditions",
    "create_gate",
    "guard_projector",
    "rotation_matrix",
    "cnot3_problem",
    "cnot3_carrier_frequencies",
    "cnot3_target",
    "cnot2_problem",
    "convert_juqbox",
    "convert_to_juqbox",
    "load_juqbox_npz",
    "sample_from_controls",
    "construct_pcof_from_sample",
    "parallel",
    "native",
    "utils",
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
]
