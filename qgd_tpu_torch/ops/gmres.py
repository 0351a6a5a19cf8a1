"""Matrix-free batched GMRES for the implicit Hermite stage (counterpart of
``qgd_tpu.ops.gmres``): the stage solve of systems too large to build the
stage matrix for.

:func:`gmres_solve` is left-preconditioned GMRES with a fixed budget of
``iters`` Arnoldi steps and no early exit, for a block of right-hand
sides ``B (S, n, b)``: scenarios times gate columns, each column its own
Krylov space, as JAX's ``vmap`` over columns gives. Each Arnoldi step
applies the operator to the whole block, so one operator call (one RHS
kernel launch on the card) serves every column; the basis is kept in the
block's layout, so a basis vector is an operator input as it stands.
Where JAX runs a masked modified Gram-Schmidt loop over all ``iters + 1``
basis vectors (3(iters + 1) small operations per Arnoldi step), each
column is projected against the filled part of its basis at once, twice
(classical Gram-Schmidt with one reorthogonalization): about 20 host
operations per Arnoldi step whatever its index, the same Krylov space and
least-squares solution to roundoff.

The ``(iters + 1, iters)`` Hessenberg least-squares problem is solved as
JAX's ``jnp.linalg.lstsq`` solves it: by SVD, minimum norm, singular values
below ``eps * max(iters + 1, iters)`` of the largest (or zero) dropped.
Past a breakdown (a Krylov space exhausted before ``iters`` steps, the
normal case for small systems) the trailing columns are roundoff, and the
cutoff discards them. Normalizations divide by at least the dtype's
smallest normal number (JAX's 1e-300 is 0 in float32).

:func:`hermite_gmres_stage` is the differentiable stage solve (JAX's
``lax.custom_linear_solve``): forward GMRES from the Taylor guess; the
backward solves the transposed system by GMRES from zero on the
transposed generator stack with the transposed preconditioner, and passes
the operator's cotangent through the VJP of its plain version; forward
mode solves for the tangent. The initial guess gets no gradient.
"""

from __future__ import annotations

import torch

from .hermite import build_lhs, scaled_derivatives
from .stage_kernels import (_derivatives_with_tangents, _weighted_tangent,
                            hermite_rhs_kernel_launch)


def _lstsq_min_norm(H: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least-squares solution ``y (..., k)`` of ``H y = beta
    e_1`` for ``H (..., k+1, k)``, ``beta (...,)``, with the singular-value
    cutoff of ``jnp.linalg.lstsq``."""
    U, s, Vh = torch.linalg.svd(H, full_matrices=False)
    rcond = torch.finfo(H.dtype).eps * max(H.shape[-2:])
    keep = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    uTb = U[..., 0, :] * beta[..., None]
    return (Vh.transpose(-1, -2) @ (s_inv * uTb)[..., None])[..., 0]


def _no_reduce(t: torch.Tensor) -> torch.Tensor:
    return t


@torch.no_grad()
def gmres_solve(matvec, B: torch.Tensor, X0: torch.Tensor, *, iters: int,
                precond=None, reduce=None) -> torch.Tensor:
    """GMRES(``iters``) for every column of ``B (S, n, b)`` from ``X0``:
    ``matvec`` and ``precond`` map ``(S, n, b)`` blocks. Returns ``(S, n,
    b)``.

    ``reduce``, if given, completes partial inner products (a sum over the
    ranks of a process group when the rows of the vectors are sharded,
    ``parallel.state_sharded``); the small least-squares solve is then the
    same on every rank. Not differentiable itself (see
    :func:`hermite_gmres_stage`)."""
    pre = precond if precond is not None else _no_reduce
    red = reduce if reduce is not None else _no_reduce
    tiny = torch.finfo(B.dtype).tiny

    def norm(w):            # (S, n, b) -> (S, 1, b), per column
        return torch.sqrt(red(torch.linalg.vecdot(w, w, dim=-2)))[:, None]

    r0 = pre(B - matvec(X0))
    beta = norm(r0)
    # the Krylov basis in the block's own layout: V[j] is an operator input
    V = B.new_empty((iters + 1,) + tuple(B.shape))
    H = B.new_zeros((iters + 1, iters, B.shape[0], B.shape[2]))
    torch.div(r0, beta.clamp(min=tiny), out=V[0])
    for j in range(iters):
        w = pre(matvec(V[j]))
        Vj = V[:j + 1]
        h = red(torch.linalg.vecdot(Vj, w, dim=-2))       # (j+1, S, b)
        w = w - (Vj * h[:, :, None]).sum(0)
        h2 = red(torch.linalg.vecdot(Vj, w, dim=-2))
        w = w - (Vj * h2[:, :, None]).sum(0)
        torch.add(h, h2, out=H[:j + 1, j])
        hn = norm(w)
        H[j + 1, j] = hn[:, 0]
        torch.div(w, hn.clamp(min=tiny), out=V[j + 1])
    y = _lstsq_min_norm(H.permute(2, 3, 0, 1), beta[:, 0])    # (S, b, k)
    return X0 + torch.einsum("ksnb,sbk->snb", V[:iters], y)


def gmres_solve_single(matvec, b: torch.Tensor, x0: torch.Tensor, *,
                       iters: int, precond=None) -> torch.Tensor:
    """GMRES(``iters``) for one right-hand side ``b (n,)``; ``matvec`` and
    ``precond`` map ``(n,)`` vectors."""
    wrap = lambda f: (None if f is None else
                      (lambda v: f(v[0, :, 0])[None, :, None]))
    return gmres_solve(wrap(matvec), b[None, :, None], x0[None, :, None],
                       iters=iters, precond=wrap(precond))[0, :, 0]


def stage_operator(A_stack: torch.Tensor, dt, m: int,
                   use_kernels: bool = True):
    """``v (S, n, b) -> LHS v = sum_j (-dt)^j c_j V_j``, the recursion on
    ``v`` with the generator stack ``A_stack (S, m, n, n)``: the RHS
    kernel at step sign -1 for float32 (its plain version on the CPU),
    plain torch for float64. The GMRES steps record no gradient (the
    stage solve differentiates implicitly), so the kernel is launched
    without its ``autograd.Function``."""
    if use_kernels and A_stack.dtype == torch.float32:
        A = A_stack.contiguous()
        return lambda v: hermite_rhs_kernel_launch(A, v, dt, m, sign=-1.0)
    return lambda v: build_lhs(scaled_derivatives(A_stack, v, m), dt, m)


class _GMRESStage(torch.autograd.Function):
    """``X = LHS(A)^{-1} B`` by GMRES (see :func:`hermite_gmres_stage`)."""

    @staticmethod
    def forward(ctx, A_stack, B, X0, dt, m, iters, precond, use_kernels):
        pc = None if precond is None else precond[0]
        X = gmres_solve(stage_operator(A_stack, dt, m, use_kernels), B, X0,
                        iters=iters, precond=pc)
        ctx.dt, ctx.m, ctx.iters = dt, m, iters
        ctx.precond, ctx.use_kernels = precond, use_kernels
        ctx.save_for_backward(A_stack, X)
        ctx.save_for_forward(A_stack, X)
        return X

    @staticmethod
    def backward(ctx, gX):
        A_stack, X = ctx.saved_tensors
        # the transposed stack, built once for this step's solve
        AT = A_stack.transpose(-1, -2).contiguous()
        pcT = None if ctx.precond is None else ctx.precond[1]
        gX = gX.contiguous()
        lam = gmres_solve(stage_operator(AT, ctx.dt, ctx.m, ctx.use_kernels),
                          gX, torch.zeros_like(gX), iters=ctx.iters,
                          precond=pcT)
        gA = None
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                a = A_stack.detach().requires_grad_(True)
                out = build_lhs(scaled_derivatives(a, X, ctx.m), ctx.dt,
                                ctx.m)
                (gA,) = torch.autograd.grad(out, a, -lam)
        return gA, lam, None, None, None, None, None, None

    @staticmethod
    def jvp(ctx, dA, dB, *_):
        A_stack, X = ctx.saved_tensors
        r = torch.zeros_like(X) if dB is None else dB
        if dA is not None:
            # the operator's derivative along dA at X: the recursion
            # differentiated level by level, step sign -1
            Vs, dVs = _derivatives_with_tangents(A_stack, dA, X, None, ctx.m)
            r = r - _weighted_tangent(Vs, dVs, -ctx.dt, None, ctx.m)
        pc = None if ctx.precond is None else ctx.precond[0]
        return gmres_solve(stage_operator(A_stack, ctx.dt, ctx.m,
                                          ctx.use_kernels),
                           r, torch.zeros_like(r), iters=ctx.iters,
                           precond=pc)


def hermite_gmres_stage(A_stack: torch.Tensor, B: torch.Tensor,
                        X0: torch.Tensor, dt, m: int, *, iters: int,
                        precond=None, use_kernels: bool = True
                        ) -> torch.Tensor:
    """Differentiable implicit-stage solve ``LHS X = B`` with the operator
    of the generator stack ``A_stack (S, m, n, n)`` (:func:`stage_operator`)
    for ``B``, ``X0 (S, n, b)``. ``precond`` is the ``(apply, apply_T)``
    pair of ``ops.preconditioners`` or ``None``. Reverse mode solves the
    transposed system by GMRES from zero with ``apply_T``; forward mode
    solves for the tangent from zero; ``X0`` gets no gradient."""
    return _GMRESStage.apply(A_stack, B, X0.detach(), dt, m, iters, precond,
                             use_kernels)
