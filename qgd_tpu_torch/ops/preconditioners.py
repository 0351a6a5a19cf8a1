"""Preconditioners of the GMRES stage solve (counterpart of
``qgd_tpu.ops.preconditioners``).

Each factory returns the ``(apply, apply_T)`` pair for the forward and the
transposed solve. Both approximate the inverse of the drift-only stage
matrix ``sum_j (-dt)^j c_j D_j`` (:func:`no_control_lhs`), built in
float64 as JAX builds it; the applies run in the dtype of the vectors they
are given. On the card float64 LU is native, so the ``"lu"``
preconditioner solves with float64 factors (JAX's mixed-precision
``refined_lu_solve`` works around a TPU without float64 LU).
"""

from __future__ import annotations

import torch

from .hermite import assemble_generator_stack, build_lhs, scaled_derivatives


def no_control_lhs(prob, dt, order: int) -> torch.Tensor:
    """The dense drift-only stage matrix ``(2N, 2N)`` in float64, of the
    problem as built (float64 operators, not its float32 working copy)."""
    m = order // 2
    if prob.system_sym.dtype != torch.float64:
        raise TypeError("no_control_lhs takes the float64 problem, not its "
                        "working copy")
    zeros = torch.zeros((m, prob.N_operators), dtype=torch.float64,
                        device=prob.device)
    A = assemble_generator_stack(prob, zeros, zeros, m)
    eye = torch.eye(prob.real_system_size, dtype=torch.float64,
                    device=prob.device)
    return build_lhs(scaled_derivatives(A, eye, m), float(dt), m)


def identity_preconditioner(prob, dt, order: int):
    """No preconditioning."""
    f = lambda v: v
    return f, f


def lu_preconditioner(prob, dt, order: int):
    """The exact inverse of the drift-only stage matrix by float64 LU."""
    LU, piv = torch.linalg.lu_factor(no_control_lhs(prob, dt, order))

    def apply(v):
        return torch.linalg.lu_solve(LU, piv, v.to(LU.dtype)).to(v.dtype)

    def apply_T(v):
        return torch.linalg.lu_solve(LU, piv, v.to(LU.dtype),
                                     adjoint=True).to(v.dtype)

    return apply, apply_T


def block2_apply(ca: torch.Tensor, cb: torch.Tensor):
    """``v (..., 2K, b) -> [[ca, cb], [-cb, ca]] v`` for the K pairs
    ``(v_i, v_{K+i})`` with per-pair coefficients ``ca``, ``cb (K,)``: one
    product with the halves in place and one with them swapped."""
    d = (torch.cat([ca, ca])[:, None], torch.cat([cb, -cb])[:, None])
    K = ca.shape[0]
    by_dtype = {}

    def apply(v):
        if v.dtype not in by_dtype:
            by_dtype[v.dtype] = tuple(x.to(v.dtype) for x in d)
        d1, d2 = by_dtype[v.dtype]
        return torch.addcmul(d1 * v, d2, torch.roll(v, K, dims=-2))

    return apply


def diagonal_coefficients(prob, dt, order: int):
    """``(a, b, det)``, each ``(N,)`` float64: the drift-only stage matrix
    of a diagonal drift Hamiltonian couples only the pairs ``(u_i, v_i)``,
    as ``[[a, b], [-b, a]]`` blocks."""
    N = prob.N_tot_levels
    M = no_control_lhs(prob, dt, order)
    a = torch.diagonal(M[:N, :N])       # upper-left diagonal (= lower-right)
    b = torch.diagonal(M[:N, N:])       # upper-right diagonal; lower-left -b
    return a, b, a * a + b * b


def diagonal_hamiltonian_preconditioner(prob, dt, order: int):
    """Exact 2x2-block elimination when the drift Hamiltonian is diagonal:
    the inverse of ``[[a, b], [-b, a]]`` is ``[[a, -b], [b, a]] / det``."""
    a, b, det = diagonal_coefficients(prob, dt, order)
    return block2_apply(a / det, -b / det), block2_apply(a / det, b / det)


PRECONDITIONERS = {
    "identity": identity_preconditioner,
    "lu": lu_preconditioner,
    "diagonal": diagonal_hamiltonian_preconditioner,
}
