"""qgd_tpu_torch — the PyTorch/CUDA port of ``qgd_tpu`` (quantum optimal
control, gate design), for NVIDIA Hopper.

What is ported: the objective and exact discrete-adjoint gradient of the
segmented route at segment length 1 with the Newton-Schulz stage solver
(``solver="schulz"``), quadratic B-spline controls, the CNOT2/CNOT3
problem builders and the stage-residual diagnostic. Control vectors are
batched as a leading tensor dimension. The two Pallas kernels of
``qgd_tpu/ops/pallas_step.py`` are hand-written CUDA kernels here
(``csrc/hermite_stage.cu``, wrapped in ``ops/stage_kernels.py``), built
with ``nvcc`` at first use on a CUDA tensor.

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
)
from .ops.hermite import (  # noqa: E402
    hermite_coefficient,
    hermite_coefficients,
    assemble_generator_stack,
    scaled_derivatives,
    build_rhs,
    build_lhs,
)
from .controls import (  # noqa: E402
    Control,
    BSpline2Control,
    control_tables,
    control_tables_at,
    total_control_parameters,
    control_vector_slice,
)
from .objective import (  # noqa: E402
    infidelity_real,
    terminal_cost,
    terminal_cost_and_grad,
    host_realify_target,
)
from .segmented import segmented_objective_and_gradient  # noqa: E402
from .diagnostics import stage_residuals  # noqa: E402
from . import models  # noqa: E402
from .models import cnot3_problem, cnot3_target, cnot2_problem  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "SchrodingerProblem",
    "schrodinger_problem",
    "schrodinger_problem_complex",
    "problem_from_arrays",
    "working_problem",
    "hermite_coefficient",
    "hermite_coefficients",
    "assemble_generator_stack",
    "scaled_derivatives",
    "build_rhs",
    "build_lhs",
    "Control",
    "BSpline2Control",
    "control_tables",
    "control_tables_at",
    "total_control_parameters",
    "control_vector_slice",
    "infidelity_real",
    "terminal_cost",
    "terminal_cost_and_grad",
    "host_realify_target",
    "segmented_objective_and_gradient",
    "stage_residuals",
    "models",
    "cnot3_problem",
    "cnot3_target",
    "cnot2_problem",
]
