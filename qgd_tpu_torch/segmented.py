"""Objective + exact discrete-adjoint gradient over a batch of control
vectors (counterpart of ``qgd_tpu.segmented.segmented_objective_and_gradient``,
``solver="schulz"``, at segment length L = 1).

At L = 1 every segment is one step, so the stored segment-boundary states
ARE the full trajectory ``(S, T+1, 2N, B)`` and the backward re-forward is
not needed: the backward reads ``w_n`` and ``w_{n+1}`` straight from the
stored trajectory (no copies). The general-L re-forward route is not
ported yet; ``n_segments`` other than ``nsteps`` raises.

Per step the forward builds ``LHS(t_{n+1})`` (LHS kernel), the explicit
half (RHS kernel), the guarded warm start from the one drift-only inverse
and the refinement solve. The backward, for ``n = T-1 .. 0``, builds
``R(t_n)`` and ``L(t_n)`` from one recursion, forms ``mu = R^T lam_{n+1} +
f_n`` (``f_n`` = guard forcing, formed in f64) and solves
``L^T lam_n = mu``. The merged per-step cotangents
``w_rhs lam_{n+1} - w_lhs lam_n`` then pass, in chunks of time points,
through the VJP of the scaled-derivative stack with respect to the
control-table values, and the pcof chain rule is one autograd pass through
:func:`~qgd_tpu_torch.controls.control_tables` at the end.
"""

from __future__ import annotations

import torch

from .controls import as_control_tuple, control_tables, control_tables_at
from .forward import (
    _time_grid,
    _warm_budget,
    _drift_stage_inverse,
    _forward_trajectory,
    _stage_matrices_both,
)
from .objective import host_realify_target, terminal_cost_and_grad
from .ops.hermite import (
    assemble_generator_stack,
    scaled_derivatives,
    build_lhs,
    hermite_coefficients,
)
from .ops.linalg import (
    REFINE_SWEEPS_F32,
    schulz_inverse_auto,
    inverse_stage_solve,
)
from .problem import working_problem

# Scenario-steps per chunk of the table VJP: bounds the autograd graph
# (about 0.6 MB per scenario-step at 2N = 128, m = 2, f32).
_TABLE_VJP_CHUNK = 2048


def _guard_quad(W, traj, tau):
    """f64 sum over time of ``tau_t <w_t, W w_t>`` for ``traj (S, C, 2N,
    B)`` -> ``(S,)``."""
    h = traj.to(torch.float64)
    per_t = torch.sum(h * (W @ h), dim=(-2, -1))
    return torch.sum(tau * per_t, dim=-1)


def _table_cot(wprob, m: int, p, q, w, cot):
    """VJP of ``scaled_derivatives(assemble_generator_stack(p, q), w)`` with
    respect to the control-table values ``(p, q) (..., m, N_ops)``, for the
    cotangent ``cot (..., m+1, 2N, B)``."""
    with torch.enable_grad():
        p = p.detach().requires_grad_(True)
        q = q.detach().requires_grad_(True)
        Ws = scaled_derivatives(assemble_generator_stack(wprob, p, q, m), w,
                                m)
        return torch.autograd.grad(Ws, (p, q), cot)


def segmented_objective_and_gradient(prob, controls, pcof, target,
                                     order: int = 4,
                                     cost_type: str = "Infidelity",
                                     ridge_penalty_strength: float = 0.0,
                                     n_segments: int = 0, *,
                                     use_kernels: bool = True,
                                     refine_sweeps: int | None = None):
    """Objective parts and gradient for a batch of control vectors.

    ``pcof`` is ``(S, N_params)`` (or ``(N_params,)``); ``target`` a
    complex ``(N, B)`` gate or its real-stacked ``(2N, B)`` form, shared by
    all scenarios. Returns ``((j1, guard, ridge), grad)`` with ``j1``,
    ``guard``, ``ridge`` of shape ``(S,)`` and ``grad (S, N_params)``,
    float64 (scalars and ``(N_params,)`` for a 1-D ``pcof``).

    ``use_kernels=False`` runs the plain torch route (the kernels' plain
    versions) on any device. ``refine_sweeps`` sets the refinement sweeps
    of f32 stage solves (default :data:`REFINE_SWEEPS_F32`); f64 solves take
    4, as in the JAX package.
    """
    if prob.solver != "schulz":
        raise NotImplementedError(
            f"solver={prob.solver!r}: only 'schulz' is ported")
    controls = as_control_tuple(controls)
    dev = prob.device
    pcof = torch.as_tensor(pcof, dtype=torch.float64).to(dev).detach()
    single = pcof.dim() == 1
    if single:
        pcof = pcof[None]
    target_real = torch.as_tensor(host_realify_target(target), device=dev)

    T = prob.nsteps
    # the automatic rule picks L = 1, the only segment length ported so far
    n_seg = n_segments if n_segments > 0 else T
    if n_seg != T:
        raise NotImplementedError(
            f"n_segments={n_seg}: only segment length 1 (n_segments = "
            f"nsteps = {T}) is ported")
    m = order // 2
    S = pcof.shape[0]

    dt64, ts = _time_grid(prob)
    with torch.enable_grad():
        pcof_leaf = pcof.clone().requires_grad_(True)
        P, Q = control_tables(controls, pcof_leaf, ts, m)
    wd = prob.work_dtype
    wprob = working_problem(prob)
    Pw, Qw = P.detach().to(wd), Q.detach().to(wd)
    dt = torch.tensor(dt64, dtype=torch.float64, device=dev).to(wd)
    if wd == torch.float32:
        sweeps = REFINE_SWEEPS_F32 if refine_sweeps is None else refine_sweeps
    else:
        sweeps = 4
    warm = _warm_budget(wprob)
    X0 = _drift_stage_inverse(wprob, m, dt)
    X0T = _drift_stage_inverse(wprob, m, dt, transpose=True)

    # ---------------- forward: trajectory, guard penalty ------------------
    traj = _forward_trajectory(wprob, m, dt, Pw, Qw, X0, use_kernels, sweeps)
    W = prob.guard_subspace_projector
    tau = torch.ones(T + 1, dtype=torch.float64, device=dev)
    tau[0] = tau[-1] = 0.5
    chunk = max(1, _TABLE_VJP_CHUNK // S)
    guard_sum = torch.zeros(S, dtype=torch.float64, device=dev)
    for a in range(0, T + 1, chunk):
        b = min(a + chunk, T + 1)
        guard_sum = guard_sum + _guard_quad(W, traj[:, a:b], tau[a:b])
    guard = guard_sum * dt64 / prob.tf

    w_final64 = traj[:, T].to(torch.float64)
    j1, dj1 = terminal_cost_and_grad(w_final64, target_real,
                                     prob.N_ess_levels, cost_type)
    n_par = pcof.shape[-1]
    ridge = ridge_penalty_strength * torch.sum(pcof * pcof, dim=-1) / n_par

    # ---------------- terminal condition ----------------------------------
    guard_scale = 2.0 * dt64 / prob.tf
    g_T = dj1 + (guard_scale * 0.5) * (W @ w_final64)
    p_f, q_f = control_tables_at(controls, pcof, prob.tf, m)
    p_f, q_f = p_f.to(wd), q_f.to(wd)
    eye = torch.eye(prob.real_system_size, dtype=wd, device=dev)
    lhs_f = build_lhs(
        scaled_derivatives(assemble_generator_stack(wprob, p_f, q_f, m), eye,
                           m), dt, m)
    MT = lhs_f.transpose(-1, -2)
    lam_T = inverse_stage_solve(MT, schulz_inverse_auto(MT, prob.schulz_iters),
                                g_T.to(wd), sweeps)

    # ---------------- backward lambda sweep --------------------------------
    # lam[:, n] = lambda_n for n = 0..T; lam[:, T+1] = 0 makes the terminal
    # cotangent -w_lhs lam_T the same formula as every step's.
    lam = torch.empty((S, T + 2) + tuple(lam_T.shape[1:]), dtype=wd,
                      device=dev)
    lam[:, T] = lam_T
    lam[:, T + 1] = 0.0
    lam_next = lam_T
    for n in range(T - 1, -1, -1):
        f_n = ((guard_scale * tau[n]) * (W @ traj[:, n].to(torch.float64))
               ).to(wd)
        R, L = _stage_matrices_both(wprob, m, dt, Pw[:, n], Qw[:, n])
        LT = L.transpose(-1, -2)
        XT = schulz_inverse_auto(LT, prob.schulz_iters, X0=X0T,
                                 warm_iters=warm)
        mu = R.transpose(-1, -2) @ lam_next + f_n
        lam_next = inverse_stage_solve(LT, XT, mu, sweeps)
        if n == 0:
            # lambda_0 carries no multiplier: the initial state is fixed
            lam_next = lam_next * 0.0
        lam[:, n] = lam_next

    # ---------------- table cotangents, then the pcof chain rule -----------
    c = torch.tensor(hermite_coefficients(m), dtype=torch.float64)
    jpow = torch.arange(m + 1, dtype=torch.float64)
    w_rhs = (c * dt64 ** jpow).to(wd).to(dev)[:, None, None]
    w_lhs = (c * (-dt64) ** jpow).to(wd).to(dev)[:, None, None]
    # tables at the T step left endpoints, then the terminal tables at tf
    P_cot = torch.cat([Pw[:, :T], p_f[:, None]], dim=1)
    Q_cot = torch.cat([Qw[:, :T], q_f[:, None]], dim=1)
    cotP = torch.empty_like(P_cot)
    cotQ = torch.empty_like(Q_cot)
    for a in range(0, T + 1, chunk):
        b = min(a + chunk, T + 1)
        cot = (w_rhs * lam[:, a + 1:b + 1, None]
               - w_lhs * lam[:, a:b, None])
        cotP[:, a:b], cotQ[:, a:b] = _table_cot(
            wprob, m, P_cot[:, a:b], Q_cot[:, a:b], traj[:, a:b], cot)
    (grad,) = torch.autograd.grad(
        (P, Q), pcof_leaf,
        (cotP.to(torch.float64), cotQ.to(torch.float64)))
    grad = grad + 2.0 * ridge_penalty_strength * pcof / n_par

    if single:
        return (j1[0], guard[0], ridge[0]), grad[0]
    return (j1, guard, ridge), grad
