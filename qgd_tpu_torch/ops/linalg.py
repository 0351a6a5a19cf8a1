"""Stage solvers (counterpart of ``qgd_tpu.ops.linalg``): the direct LU
solves of ``solver="lu"`` (library ``torch.linalg`` calls, as the JAX
package leaves them to XLA), Newton-Schulz approximate inverses and the
iterative-refinement stage solve of ``solver="schulz"``. Every solve is
differentiable by autograd. The JAX package's f32-LU-with-f64-refinement
solve exists for a backend without f64 LU; the card has one, so it is not
here.

All matmuls run at full fp32 or f64: the package pins TF32 off at import
(``qgd_tpu_torch/__init__.py``). The JAX package runs the Newton-Schulz
construction and the f32 preconditioner applies at reduced TPU precision;
here both stay full precision until a measured stage residual on the card
says otherwise.
"""

from __future__ import annotations

import torch

# Refinement sweeps for f32 right-hand sides. The JAX package defaults to
# 2 (QGD_REFINE_SWEEPS_F32) and its benchmark sets 3; the 1e-7 stage
# residual guard was only ever measured at 3, so 3 is the default here.
REFINE_SWEEPS_F32 = 3


def factorize_stages(M: torch.Tensor):
    """Batched LU factorization ``(lu, piv)`` of stage matrices
    ``M (..., n, n)``, in ``M.dtype``. No singularity check: that would
    wait for the device (as in JAX, a singular stage gives non-finite
    values)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(M)
    return lu, piv


def solve_factored(lu_n: torch.Tensor, piv_n: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Solve ``M x = b`` with the factorization ``(lu_n, piv_n)`` of ``M``
    from :func:`factorize_stages`, in the factors' dtype."""
    return torch.linalg.lu_solve(lu_n, piv_n, b)


def stage_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Dense solve ``A X = B`` of the implicit stage (batched), without the
    singularity check that would wait for the device."""
    return torch.linalg.solve_ex(A, B)[0]


def stage_solve_transposed(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``A^T X = B`` (terminal-condition and adjoint solves)."""
    return stage_solve(A.transpose(-1, -2), B)


def schulz_inverse(M: torch.Tensor, X0: torch.Tensor,
                   iters: int = 8) -> torch.Tensor:
    """Newton-Schulz iteration ``X <- X (2I - M X)`` (batched over leading
    dimensions); converges quadratically when ``||I - M X0|| < 1``."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    X = X0
    for _ in range(iters):
        X = X @ (2.0 * eye - M @ X)
    return X


def schulz_universal_init(M: torch.Tensor) -> torch.Tensor:
    """``X0 = M^T / (||M||_1 ||M||_inf)``, for which Newton-Schulz
    converges for any nonsingular ``M``."""
    MT = M.transpose(-1, -2)
    absM = M.abs()
    n1 = absM.sum(dim=-2).amax(dim=-1)
    ninf = absM.sum(dim=-1).amax(dim=-1)
    return MT / (n1 * ninf)[..., None, None]


def schulz_warm_iters(total_iters: int) -> int:
    """Warm-start budget derived from the total: ``max(total - 40, 8)``."""
    return max(total_iters - 40, 8)


def schulz_inverse_auto(M: torch.Tensor, iters: int = 56,
                        dtype=torch.float32, X0: torch.Tensor | None = None,
                        warm_iters: int | None = None) -> torch.Tensor:
    """Approximate inverse of ``M (..., n, n)`` by Newton-Schulz, computed in
    ``dtype`` (f32 by default, also for an f64 ``M``, as in JAX).

    Without ``X0``: ``iters`` iterations from the universal init. With
    ``X0`` (e.g. the drift-only stage inverse, broadcast over the batch):
    a convergence guard first computes ``R = I - M X0`` and falls back, per
    matrix, to the universal init where ``||R||_F >= 1`` (Newton-Schulz
    diverges there); then ``warm_iters`` iterations run (default
    ``schulz_warm_iters(iters)``). ``warm_iters = 0`` returns the guarded
    start itself: the guard's product is still paid.
    """
    M32 = M.to(dtype)
    if X0 is None:
        X0 = schulz_universal_init(M32)
    else:
        X0 = X0.to(dtype)
        eye = torch.eye(M32.shape[-1], dtype=dtype, device=M32.device)
        R = eye - M32 @ X0
        r = torch.sqrt(torch.sum(R * R, dim=(-2, -1), keepdim=True))
        X0 = torch.where(r < 1.0, X0, schulz_universal_init(M32))
        iters = warm_iters if warm_iters is not None else \
            schulz_warm_iters(iters)
    return schulz_inverse(M32, X0, iters)


def inverse_stage_solve(M: torch.Tensor, Xinv: torch.Tensor,
                        B: torch.Tensor, refine_iters: int | None = None,
                        transpose: bool = False) -> torch.Tensor:
    """Solve ``M X = B`` (``M^T X = B`` with ``transpose=True``) given an
    approximate inverse ``Xinv``: ``x = Xinv b``, then ``refine_iters``
    sweeps ``x <- x + Xinv (b - M x)`` with residuals in ``B.dtype``.

    ``refine_iters`` defaults to :data:`REFINE_SWEEPS_F32` for an f32
    right-hand side and 4 for f64 (the JAX package's rule).
    """
    bd = B.dtype
    if refine_iters is None:
        refine_iters = REFINE_SWEEPS_F32 if bd == torch.float32 else 4
    Mop = M.transpose(-1, -2) if transpose else M
    Xop = (Xinv.transpose(-1, -2) if transpose else Xinv).to(bd)
    x = Xop @ B
    for _ in range(refine_iters):
        r = B - Mop @ x
        x = x + Xop @ r
    return x
