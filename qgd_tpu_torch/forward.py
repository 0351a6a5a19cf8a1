"""Pieces of the Hermite propagation shared by the segmented gradient and
the diagnostics (counterpart of the ``solver="schulz"`` parts of
``qgd_tpu.forward``). Scenarios are a leading dimension of every tensor.

Kernel routing (``use_kernels=True``) follows the JAX package: the
implicit-stage matrices go through the LHS kernel where JAX uses its
Pallas kernel (f32, m >= 2, ``forward.py:135-148``), and the explicit half
of a step goes through the RHS kernel for f32 tensors (JAX computes that
half with XLA ops, ``segmented.py:203-205``). On the CPU the kernel
wrappers run their plain versions; ``use_kernels=False`` is the plain
route everywhere.
"""

from __future__ import annotations

import torch

from .ops.hermite import (
    assemble_generator_stack,
    scaled_derivatives,
    build_rhs,
    build_lhs,
)
from .ops.linalg import schulz_inverse_auto, inverse_stage_solve
from .ops.stage_kernels import (
    hermite_lhs_matrix_kernel_call,
    hermite_rhs_kernel_call,
)


def _time_grid(prob):
    """``(dt, ts)``: float64 step and ``ts = arange(T+1) * dt``."""
    dt = prob.tf / prob.nsteps
    ts = torch.arange(prob.nsteps + 1, dtype=torch.float64,
                      device=prob.device) * dt
    return dt, ts


def _warm_budget(prob):
    """Explicit warm-start Schulz budget, or ``None`` for the derived
    default (``schulz_warm_iters(prob.schulz_iters)``)."""
    return prob.schulz_warm_budget if prob.schulz_warm_budget >= 0 else None


def _stage_from_stack(A, m: int, dt, sign: float, use_kernels: bool = True):
    """Dense one-step matrices ``sum_j (sign*dt)^j c_j D_j`` from generator
    stacks ``A (..., m, n, n)`` -> ``(..., n, n)`` (``_stage_matrices`` of
    the JAX package, on a stack the caller assembled once). The f32,
    m >= 2 build goes through the LHS kernel."""
    if use_kernels and m >= 2 and A.dtype == torch.float32:
        batch = A.shape[:-3]
        flat = A.reshape((-1,) + A.shape[-3:]).contiguous()
        # the kernel computes sum_j (-d)^j c_j D_j for input d: d = -sign*dt
        # (dt itself for the implicit side: no op on the card)
        d = dt if sign == -1.0 else -sign * dt
        out = hermite_lhs_matrix_kernel_call(flat, d, m)
        return out.reshape(batch + out.shape[-2:])
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return build_rhs(scaled_derivatives(A, eye, m), sign * dt, m)


def _stage_matrices_both(prob, m: int, dt, P, Q):
    """Both one-step matrices ``(RHS, LHS)`` from one identity recursion
    (plain torch, as in JAX)."""
    A = assemble_generator_stack(prob, P, Q, m)
    eye = torch.eye(prob.real_system_size, dtype=A.dtype, device=A.device)
    D = scaled_derivatives(A, eye, m)
    return build_rhs(D, dt, m), build_lhs(D, dt, m)


def _explicit_half(A_n, w, dt, m: int, use_kernels: bool = True):
    """``build_rhs(scaled_derivatives(A_n, w), dt)`` for ``A_n (S, m, n,
    n)``, ``w (S, n, b)``; through the RHS kernel for f32 tensors."""
    if use_kernels and w.dtype == torch.float32:
        return hermite_rhs_kernel_call(A_n.contiguous(), w.contiguous(), dt,
                                       m)
    return build_rhs(scaled_derivatives(A_n, w, m), dt, m)


def _drift_stage_inverse(prob, m: int, dt, transpose: bool = False):
    """Newton-Schulz inverse of the drift-only implicit stage matrix (f32,
    ``prob.schulz_iters`` iterations from the universal init): the warm
    start / preconditioner of every stage solve."""
    wd = prob.work_dtype
    zeros_pq = torch.zeros((m, prob.N_operators), dtype=wd,
                           device=prob.device)
    A = assemble_generator_stack(prob, zeros_pq, zeros_pq, m)
    eye = torch.eye(prob.real_system_size, dtype=wd, device=prob.device)
    lhs = build_lhs(scaled_derivatives(A, eye, m), dt, m)
    if transpose:
        lhs = lhs.T
    return schulz_inverse_auto(lhs, prob.schulz_iters)


def _hermite_step(prob, m: int, dt, w, pq_n, pq_np1, schulz_X0=None,
                  use_kernels: bool = True, refine_iters=None):
    """One ``solver="schulz"`` Hermite step ``w_n -> w_{n+1}`` for the
    batch ``w (S, n, b)`` with control tables ``pq_* = (P, Q)`` of shape
    ``(S, m, N_ops)``. Returns ``(w_next, lhs, rhs)``: the solve's result
    and the system it solved (the diagnostics measure its residual)."""
    A_n = assemble_generator_stack(prob, pq_n[0], pq_n[1], m)
    A_np1 = assemble_generator_stack(prob, pq_np1[0], pq_np1[1], m)
    return _step_from_stacks(prob, m, dt, w, A_n, A_np1, schulz_X0,
                             use_kernels, refine_iters)


def _step_from_stacks(prob, m: int, dt, w, A_n, A_np1, schulz_X0,
                      use_kernels: bool, refine_iters):
    rhs = _explicit_half(A_n, w, dt, m, use_kernels)
    lhs = _stage_from_stack(A_np1, m, dt, -1.0, use_kernels)
    X = schulz_inverse_auto(lhs, prob.schulz_iters, X0=schulz_X0,
                            warm_iters=_warm_budget(prob))
    return inverse_stage_solve(lhs, X, rhs, refine_iters), lhs, rhs


def _forward_trajectory(prob, m: int, dt, P, Q, schulz_X0,
                        use_kernels: bool = True, refine_iters=None):
    """Propagate ``prob.w0`` through all ``T = prob.nsteps`` steps for the
    scenario batch of tables ``P, Q (S, T+1, m, N_ops)`` (work dtype).
    Returns the trajectory ``(S, T+1, 2N, B)``. Each time point's generator
    stack is assembled once and serves as the implicit side of one step
    and the explicit side of the next."""
    S, T = P.shape[0], prob.nsteps
    w = prob.w0.expand(S, -1, -1)
    traj = torch.empty((S, T + 1) + tuple(w.shape[1:]), dtype=w.dtype,
                       device=w.device)
    traj[:, 0] = w
    A_n = assemble_generator_stack(prob, P[:, 0], Q[:, 0], m)
    for k in range(T):
        A_np1 = assemble_generator_stack(prob, P[:, k + 1], Q[:, k + 1], m)
        w, _, _ = _step_from_stacks(prob, m, dt, w, A_n, A_np1, schulz_X0,
                                    use_kernels, refine_iters)
        traj[:, k + 1] = w
        A_n = A_np1
    return traj
