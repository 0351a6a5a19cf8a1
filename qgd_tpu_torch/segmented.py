"""Objective + exact discrete-adjoint gradient over a batch of control
vectors with bounded memory (counterpart of ``qgd_tpu.segmented``), and
the value-only forward the multistart line search probes.

The ``T`` steps are cut into ``n_segments`` segments of ``L = T /
n_segments`` steps (scenarios are the leading tensor dimension
throughout):

* **Forward.** Segment by segment (:func:`~qgd_tpu_torch.forward.
  _forward_segment_scan`: the segment's implicit-stage matrices in one
  LHS-kernel launch at batch S·L in f32, their Newton-Schulz inverses or
  LU factors, then per step the explicit half through the RHS kernel and
  the solve). Only the segment-start states are kept; the guard penalty
  is summed in f64 on the way.
* **Backward.** Segments in reverse: re-forward the segment from its
  stored start state, build ``R(t_n)`` and ``L(t_n)`` at its L left
  endpoints (plain torch, as in JAX), run the multiplier sweep
  ``L^T lam_n = R^T lam_{n+1} + f_n`` (``f_n`` the guard forcing, formed
  in f64) and pass the merged cotangents ``w_rhs lam_{n+1} - w_lhs
  lam_n`` through the VJP of the scaled-derivative stack with respect to
  the control-table values. The pcof chain rule is one autograd pass
  through :func:`~qgd_tpu_torch.controls.control_tables` at the end.

Peak memory is O(n_segments + L) states plus one segment's ``(S·L, 2N,
2N)`` stage tensors. At L = 1 the stored segment starts ARE the
trajectory, so that route keeps the trajectory, makes no re-forward and
reads ``w_n`` straight from it.

``solver="gmres"`` steps each forward and re-forward through the GMRES
stage (no stage matrix is built there); its backward sweep solves the
transposed stage densely by LU, as the JAX package's does.
"""

from __future__ import annotations

import math
import os

import torch

from .controls import as_control_tuple, control_tables, control_tables_at
from .forward import (
    _chunks,
    _time_grid,
    _scenario_pcof,
    _warm_budget,
    _drift_stage_inverse,
    _forward_segment_scan,
    _forward_trajectory,
    _hoisted_inverses,
    _hoisted_stage_pairs,
    _make_preconditioner,
    _stage_matrices_both,
)
from .objective import (
    guard_penalty_real,
    ic_sum,
    ridge_penalty,
    target_on_device,
    terminal_cost,
    terminal_cost_and_grad,
)
from .ops.hermite import (
    assemble_generator_stack,
    scaled_derivatives,
    build_lhs,
    hermite_coefficients,
)
from .ops.linalg import (
    REFINE_SWEEPS_F32,
    factorize_stages,
    schulz_inverse_auto,
    inverse_stage_solve,
    solve_factored,
    stage_solve_transposed,
)
from .problem import working_problem

# Budget of the stored states on the card for the automatic segment rule
# (GB), read once at import, as in the JAX package.
_SEG_STATE_BUDGET_GB = float(os.environ.get("QGD_SEG_STATE_BUDGET_GB", "4"))


def _divisors(n: int) -> list:
    """The divisors of ``n >= 1`` in increasing order, from its prime
    factorization."""
    divs = [1]
    p = 2
    while p * p <= n:
        e = 0
        while n % p == 0:
            n //= p
            e += 1
        divs = [d * p ** k for d in divs for k in range(e + 1)]
        p += 1
    if n > 1:
        divs = [d * f for d in divs for f in (1, n)]
    return sorted(divs)


def choose_segments(nsteps: int, target_len: int = 0) -> int:
    """A segment count dividing ``nsteps`` with segment length near
    ``sqrt(nsteps)`` (or near ``target_len`` if given): of the divisors,
    the one closest to ``nsteps // length``, the smaller on a tie."""
    want_len = target_len if target_len > 0 else int(math.sqrt(nsteps))
    want_S = max(nsteps // max(want_len, 1), 1)
    return min(_divisors(nsteps), key=lambda S: (abs(S - want_S), S))


def _auto_segments(prob, nsteps: int, batch: int,
                   working_states: int = 0) -> int:
    """The automatic segment count for ``batch`` scenarios.

    f32 on the card: the largest count whose stored states fit the budget
    (``QGD_SEG_STATE_BUDGET_GB``, 4 GB by default), ``n·cols·4`` bytes per
    state and scenario. This is the JAX package's TPU rule counted for the
    port's backward: at L = 1 it holds the trajectory (T+1 states) and
    the multipliers (T+2), where JAX counts the trajectory once; at
    general L it holds the n_segments + 1 segment-start states (plus one
    segment's O(L)), plus ``working_states`` a step holds besides (a GMRES
    step's Krylov basis). The batch is the one the call really has, not
    ``prob.hoist_batch_hint``. Fewer segments are faster on the card as on
    the TPU: at L = 1 nothing is re-forwarded.

    f64, and anything on the CPU: segment length near sqrt(nsteps), as in
    JAX (the verification footing, where O(sqrt T) memory is the point).
    """
    if prob.device.type != "cuda" or prob.work_dtype != torch.float32:
        return choose_segments(nsteps)
    per_state = (max(int(batch), 1) * prob.real_system_size
                 * max(prob.N_initial_conditions, 1) * 4)
    budget = _SEG_STATE_BUDGET_GB * 2 ** 30
    if (2 * nsteps + 3 + working_states) * per_state <= budget:
        return nsteps                                   # L = 1
    max_S = max(int(budget / per_state) - 1 - working_states, 1)
    S_sqrt = choose_segments(nsteps)
    # the largest count under the budget; if even the sqrt choice is over
    # it, sqrt memory is the lesser evil (fewer segments would grow the
    # per-segment (S·L, n, n) stage tensors instead)
    fits = [d for d in _divisors(nsteps) if S_sqrt <= d <= max_S
            and d < nsteps]
    return max(fits) if fits else S_sqrt


def _segment_count(prob, n_segments: int, batch: int) -> int:
    T = prob.nsteps
    krylov = prob.gmres_iters + 1 if prob.solver == "gmres" else 0
    n_seg = (n_segments if n_segments > 0
             else _auto_segments(prob, T, batch, krylov))
    if T % n_seg:
        raise ValueError(f"n_segments={n_seg} must divide nsteps={T}")
    return n_seg


def _no_graph(x):
    """``x`` cut from the autograd graph with its forward-mode tangent kept
    (``detach`` drops it): the Hessian differentiates the Lagrange
    gradient in forward mode (``adjoint.eval_hessian``)."""
    with torch.no_grad():
        return x.clone()


def _table_cot(wprob, m: int, p, q, w, cot):
    """VJP of ``scaled_derivatives(assemble_generator_stack(p, q), w)`` with
    respect to the control-table values ``(p, q) (..., m, N_ops)``, for the
    cotangent ``cot (..., m+1, 2N, B)``."""
    with torch.enable_grad():
        p = _no_graph(p).requires_grad_(True)
        q = _no_graph(q).requires_grad_(True)
        Ws = scaled_derivatives(assemble_generator_stack(wprob, p, q, m), w,
                                m)
        return torch.autograd.grad(Ws, (p, q), cot)


def _cot_weights(m: int, dt64: float, wd, dev):
    """``(w_rhs, w_lhs)`` ``(m+1, 1, 1)``: ``c_j dt^j`` and ``c_j (-dt)^j``
    in the work dtype."""
    c = torch.tensor(hermite_coefficients(m), dtype=torch.float64)
    jpow = torch.arange(m + 1, dtype=torch.float64)
    return ((c * dt64 ** jpow).to(wd).to(dev)[:, None, None],
            (c * (-dt64) ** jpow).to(wd).to(dev)[:, None, None])


def _table_cotangents(wprob, m: int, w_rhs, w_lhs, P_cot, Q_cot, lam,
                      states):
    """Control-table cotangents ``(cotP, cotQ)`` at the ``T'`` time points
    of ``P_cot, Q_cot (S, T', m, N_ops)``, whose states are ``states (S,
    T', 2N, B)`` and multipliers ``lam (S, T'+1, 2N, B)`` (the merged
    cotangent at point k is ``w_rhs lam[k+1] - w_lhs lam[k]``), in chunks
    of time points."""
    cotP = torch.empty_like(P_cot)
    cotQ = torch.empty_like(Q_cot)
    for a, b in _chunks(P_cot.shape[1], P_cot.shape[0]):
        cot = (w_rhs * lam[:, a + 1:b + 1, None]
               - w_lhs * lam[:, a:b, None])
        cotP[:, a:b], cotQ[:, a:b] = _table_cot(
            wprob, m, P_cot[:, a:b], Q_cot[:, a:b], states[:, a:b], cot)
    return cotP, cotQ


class _Work:
    """What every segmented pass shares: the working problem, the step in
    the work dtype, the tables ``(S, T+1, m, N_ops)`` in the work dtype,
    the refinement sweeps, the GMRES preconditioner (``solver="gmres"``),
    the trapezoid weights ``tau`` of the tables' time points (f64; by
    default the whole horizon's, 1/2 at both ends) and, if
    ``drift_inverse``, the drift-only inverse that warm-starts the
    Newton-Schulz inverses (``X0``)."""

    def __init__(self, prob, P, Q, m: int, refine_sweeps, use_kernels,
                 drift_inverse: bool, tau=None):
        self.prob, self.m, self.use_kernels = prob, m, use_kernels
        self.dt64 = prob.tf / prob.nsteps
        self.wd = prob.work_dtype
        self.wprob = working_problem(prob)
        self.Pw, self.Qw = P.detach().to(self.wd), Q.detach().to(self.wd)
        self.dt = torch.tensor(self.dt64, dtype=torch.float64,
                               device=prob.device).to(self.wd)
        if self.wd == torch.float32:
            self.sweeps = (REFINE_SWEEPS_F32 if refine_sweeps is None
                           else refine_sweeps)
        else:
            self.sweeps = 4
        self.schulz = prob.solver == "schulz"
        self.X0 = (_drift_stage_inverse(self.wprob, m, self.dt)
                   if drift_inverse else None)
        self.precond = _make_preconditioner(prob, self.dt64, 2 * m)
        if tau is None:
            tau = torch.ones(prob.nsteps + 1, dtype=torch.float64,
                             device=prob.device)
            tau[0] = tau[-1] = 0.5
        self.tau = tau

    def segment(self, a: int, b: int, w_start):
        """History ``(S, b-a+1, 2N, B)`` of steps ``a..b`` from
        ``w_start``."""
        Pw, Qw = self.Pw, self.Qw
        return _forward_segment_scan(
            self.wprob, self.m, self.dt, Pw[:, a:b], Qw[:, a:b],
            Pw[:, a + 1:b + 1], Qw[:, a + 1:b + 1], w_start, self.X0,
            self.use_kernels, self.sweeps, self.precond)

    def guard_part(self, hist, a: int):
        """f64 trapezoid-weighted ``sum_t tau_t <w_t, W w_t>`` over
        ``hist (S, k, 2N, B)`` at global indices ``a..a+k-1``."""
        W = self.prob.guard_subspace_projector
        h = hist.to(torch.float64)
        per_t = torch.sum(h * (W @ h), dim=(-2, -1))
        return torch.sum(self.tau[a:a + h.shape[1]] * per_t, dim=-1)

    def forcing(self, hist, a: int):
        """Guard forcing ``(2 dt / T) tau_n W w_n`` at the states ``hist
        (S, k, 2N, B)`` of global indices ``a..a+k-1``, formed in f64."""
        tau = self.tau[a:a + hist.shape[1]]
        scale = (2.0 * self.dt64 / self.prob.tf) * tau
        f = scale[:, None, None] * (self.prob.guard_subspace_projector
                                    @ hist.to(torch.float64))
        return f.to(self.wd)


def _snapshot_pass(work, n_seg: int, keep: bool):
    """The segmented forward: ``(w_final, guard, starts)`` with the guard
    penalty ``(S,)`` f64 and, if ``keep``, the segment-start states ``(S,
    n_seg, 2N, B)``."""
    T = work.prob.nsteps
    L = T // n_seg
    w = work.wprob.w0.expand(work.Pw.shape[0], -1, -1)
    starts = (torch.empty((w.shape[0], n_seg) + tuple(w.shape[1:]),
                          dtype=w.dtype, device=w.device) if keep else None)
    guard = torch.zeros(w.shape[0], dtype=torch.float64, device=w.device)
    for k in range(n_seg):
        if keep:
            starts[:, k] = w
        hist = work.segment(k * L, (k + 1) * L, w)
        guard = guard + work.guard_part(hist[:, :-1], k * L)
        w = hist[:, -1]
    guard = guard + work.guard_part(w[:, None], T)
    return w, guard * work.dt64 / work.prob.tf, starts


def _l1_forward(work):
    """The L = 1 forward: ``(trajectory (S, T+1, 2N, B), guard)``."""
    traj = _forward_trajectory(work.wprob, work.m, work.dt, work.Pw,
                               work.Qw, work.X0, work.use_kernels,
                               work.sweeps, work.precond)
    guard = guard_penalty_real(traj, work.dt64, work.prob.tf,
                               work.prob.guard_subspace_projector)
    return traj, guard


def _terminal_multiplier(work, p_f, q_f, g_T, schulz: bool):
    """``lambda_T``: solve ``LHS(t_f)^T lambda = g_T`` in the work dtype,
    by a Newton-Schulz inverse and refinement (``schulz``) or LU."""
    prob, m, wd = work.prob, work.m, work.wd
    eye = torch.eye(prob.real_system_size, dtype=wd, device=prob.device)
    lhs_f = build_lhs(scaled_derivatives(
        assemble_generator_stack(work.wprob, p_f, q_f, m), eye, m),
        work.dt, m)
    if schulz:
        MT = lhs_f.transpose(-1, -2)
        return inverse_stage_solve(
            MT, schulz_inverse_auto(MT, prob.schulz_iters), g_T.to(wd),
            work.sweeps)
    return stage_solve_transposed(lhs_f, g_T.to(wd))


def _l1_backward(work, traj, lam_T, w_rhs, w_lhs, p_f, q_f):
    """The L = 1 backward: multipliers by a per-step sweep reading the
    stored trajectory, then the table cotangents ``(S, T+1, m, N_ops)``."""
    prob, m, wd = work.prob, work.m, work.wd
    S, T = traj.shape[0], prob.nsteps
    X0T = (_drift_stage_inverse(work.wprob, m, work.dt, transpose=True)
           if work.schulz else None)
    warm = _warm_budget(work.wprob)
    # lam[:, n] = lambda_n for n = 0..T; lam[:, T+1] = 0 makes the terminal
    # cotangent -w_lhs lam_T the same formula as every step's
    lam = torch.empty((S, T + 2) + tuple(lam_T.shape[1:]), dtype=wd,
                      device=prob.device)
    lam[:, T] = lam_T
    lam[:, T + 1] = 0.0
    lam_next = lam_T
    for n in range(T - 1, -1, -1):
        f_n = work.forcing(traj[:, n:n + 1], n)[:, 0]
        R, L = _stage_matrices_both(work.wprob, m, work.dt, work.Pw[:, n],
                                    work.Qw[:, n])
        mu = R.transpose(-1, -2) @ lam_next + f_n
        if work.schulz:
            LT = L.transpose(-1, -2)
            XT = schulz_inverse_auto(LT, prob.schulz_iters, X0=X0T,
                                     warm_iters=warm)
            lam_next = inverse_stage_solve(LT, XT, mu, work.sweeps)
        else:
            lam_next = stage_solve_transposed(L, mu)
        if n == 0:
            # lambda_0 carries no multiplier: the initial state is fixed
            lam_next = lam_next * 0.0
        lam[:, n] = lam_next
    # tables at the T step left endpoints, then the terminal tables at tf
    P_cot = torch.cat([work.Pw[:, :T], p_f[:, None]], dim=1)
    Q_cot = torch.cat([work.Qw[:, :T], q_f[:, None]], dim=1)
    return _table_cotangents(work.wprob, m, w_rhs, w_lhs, P_cot, Q_cot, lam,
                             traj)


def _segment_backward_step(work, a: int, b: int, w_start, lam_b, X0T,
                           w_rhs, w_lhs, lam0_scale=None):
    """One segment of the general-L backward (module docstring), steps
    ``a..b``: re-forward from ``w_start``, the multiplier sweep from
    ``lam_b`` (lambda at step b) and the table cotangents ``(S, L, m,
    N_ops)`` at the segment's L left endpoints. ``lam0_scale``, if given,
    multiplies lambda at step a before the cotangents are formed (0 for
    the segment that starts at t_0, whose state is fixed). Returns
    ``(lambda_a, cotP, cotQ)``."""
    m, L = work.m, b - a
    hist = work.segment(a, b, w_start)                       # re-forward
    f_seg = work.forcing(hist[:, :-1], a)
    R, Lm = _hoisted_stage_pairs(work.wprob, m, work.dt, work.Pw[:, a:b],
                                 work.Qw[:, a:b])
    LT = Lm.transpose(-1, -2)
    del Lm
    if work.schulz:
        XT = _hoisted_inverses(work.wprob, m, work.dt, LT, X0=X0T)

        def solve(i, mu):
            return inverse_stage_solve(LT[:, i], XT[:, i], mu, work.sweeps)
    else:
        lu, piv = factorize_stages(LT)

        def solve(i, mu):
            return solve_factored(lu[:, i], piv[:, i], mu)

    lam_seg = torch.empty_like(hist)            # lam_seg[:, i] = lam_{a+i}
    lam_seg[:, L] = lam_b
    lam = lam_b
    for i in range(L - 1, -1, -1):
        lam = solve(i, R[:, i].transpose(-1, -2) @ lam + f_seg[:, i])
        lam_seg[:, i] = lam
    if lam0_scale is not None:
        lam_seg[:, 0] *= lam0_scale
    cotP, cotQ = _table_cotangents(work.wprob, m, w_rhs, w_lhs,
                                   work.Pw[:, a:b], work.Qw[:, a:b], lam_seg,
                                   hist)
    return lam_seg[:, 0], cotP, cotQ


def _segment_backward(work, n_seg: int, starts, w_final, lam_T, w_rhs,
                      w_lhs, p_f, q_f):
    """The general-L backward (module docstring): the table cotangents
    ``(S, T+1, m, N_ops)``."""
    prob, m, wd = work.prob, work.m, work.wd
    T = prob.nsteps
    L = T // n_seg
    X0T = (_drift_stage_inverse(work.wprob, m, work.dt, transpose=True)
           if work.schulz else None)
    cotP = torch.empty((work.Pw.shape[0], T + 1) + tuple(work.Pw.shape[2:]),
                       dtype=wd, device=prob.device)
    cotQ = torch.empty_like(cotP)
    lam_b = lam_T
    for k in range(n_seg - 1, -1, -1):
        a, b = k * L, (k + 1) * L
        # the initial state is fixed: lambda_0 carries no multiplier
        lam_b, cotP[:, a:b], cotQ[:, a:b] = _segment_backward_step(
            work, a, b, starts[:, k], lam_b, X0T, w_rhs, w_lhs,
            0.0 if k == 0 else None)
    # terminal index T: only the LHS term survives (no step starts at T)
    cotP[:, T], cotQ[:, T] = _table_cot(work.wprob, m, p_f, q_f, w_final,
                                        -w_lhs * lam_T[:, None])
    return cotP, cotQ


def segmented_objective_and_gradient(prob, controls, pcof, target,
                                     order: int = 4,
                                     cost_type: str = "Infidelity",
                                     ridge_penalty_strength: float = 0.0,
                                     n_segments: int = 0, *,
                                     use_kernels: bool = True,
                                     refine_sweeps: int | None = None,
                                     ic_group=None):
    """Objective parts and gradient for a batch of control vectors, with
    memory bounded by the segment count (module docstring).

    ``pcof`` is ``(S, N_params)`` (or ``(N_params,)``); ``target`` a
    complex ``(N, B)`` gate or its real-stacked ``(2N, B)`` form, shared by
    all scenarios. ``n_segments`` must divide ``nsteps``; 0 picks it
    (:func:`_auto_segments`). Returns ``((j1, guard, ridge), grad)`` with
    ``j1``, ``guard``, ``ridge`` of shape ``(S,)`` and ``grad (S,
    N_params)``, float64 (scalars and ``(N_params,)`` for a 1-D ``pcof``).

    ``use_kernels=False`` runs the plain torch route (the kernels' plain
    versions) on any device. ``refine_sweeps`` sets the refinement sweeps
    of f32 Schulz stage solves (default :data:`REFINE_SWEEPS_F32`); f64
    solves take 4, as in the JAX package.

    ``ic_group``: a process group whose ranks each hold some gate columns
    of ``prob`` and ``target`` (``parallel.sharded``); the infidelity's
    traces, the guard and the gradient are summed over it, as
    ``adjoint.objective_and_gradient`` sums them. The automatic segment
    count is this rank's: its scenarios and its columns.
    """
    controls = as_control_tuple(controls)
    pcof, single = _scenario_pcof(prob, pcof)
    pcof = pcof.detach()
    n_seg = _segment_count(prob, n_segments, pcof.shape[0])
    T, m = prob.nsteps, order // 2
    dt64, ts = _time_grid(prob)
    with torch.enable_grad():
        pcof_leaf = pcof.clone().requires_grad_(True)
        P, Q = control_tables(controls, pcof_leaf, ts, m)
    work = _Work(prob, P, Q, m, refine_sweeps, use_kernels,
                 prob.solver == "schulz")
    wd = work.wd

    # ---------------- forward: final state, guard penalty -----------------
    if n_seg == T:
        traj, guard = _l1_forward(work)
        w_final = traj[:, T]
    else:
        w_final, guard, starts = _snapshot_pass(work, n_seg, keep=True)
    w_final64 = w_final.to(torch.float64)
    j1, dj1 = terminal_cost_and_grad(w_final64, target_on_device(prob, target),
                                     prob.N_ess_levels, cost_type, ic_group)
    guard = ic_sum(guard, ic_group)
    ridge = ridge_penalty(pcof, ridge_penalty_strength)

    # ---------------- terminal condition ----------------------------------
    g_T = dj1 + (dt64 / prob.tf) * (prob.guard_subspace_projector
                                     @ w_final64)
    p_f, q_f = control_tables_at(controls, pcof, prob.tf, m)
    p_f, q_f = p_f.to(wd), q_f.to(wd)
    lam_T = _terminal_multiplier(work, p_f, q_f, g_T, work.schulz)

    # ---------------- backward, table cotangents, pcof chain rule ---------
    w_rhs, w_lhs = _cot_weights(m, dt64, wd, prob.device)
    if n_seg == T:
        cotP, cotQ = _l1_backward(work, traj, lam_T, w_rhs, w_lhs, p_f, q_f)
    else:
        cotP, cotQ = _segment_backward(work, n_seg, starts, w_final, lam_T,
                                       w_rhs, w_lhs, p_f, q_f)
    (grad,) = torch.autograd.grad(
        (P, Q), pcof_leaf,
        (cotP.to(torch.float64), cotQ.to(torch.float64)))
    grad = ic_sum(grad, ic_group)
    grad = grad + 2.0 * ridge_penalty_strength * pcof / pcof.shape[-1]

    if single:
        return (j1[0], guard[0], ridge[0]), grad[0]
    return (j1, guard, ridge), grad


def segmented_gradient(prob, controls, pcof, target, order: int = 4,
                       cost_type: str = "Infidelity", n_segments: int = 0):
    """Gradient only (the ``discrete_adjoint`` shape)."""
    _, grad = segmented_objective_and_gradient(
        prob, controls, pcof, target, order, cost_type=cost_type,
        n_segments=n_segments)
    return grad


def segmented_objective_value(prob, controls, pcof, target, order: int = 4,
                              cost_type: str = "Infidelity",
                              ridge_penalty_strength: float = 0.0,
                              n_segments: int = 0, *,
                              use_kernels: bool = True,
                              refine_sweeps: int | None = None,
                              ic_group=None):
    """Value only (one forward pass, no adjoint work): ``j1 + guard +
    ridge``, ``(S,)`` float64 (a scalar for a 1-D ``pcof``). The line-search
    probe of ``optimize_gate_multistart(gradient_route="segmented")``; both
    kernels run at batch S (the LHS kernel at S·L per segment).
    ``ic_group`` as in :func:`segmented_objective_and_gradient`."""
    controls = as_control_tuple(controls)
    pcof, single = _scenario_pcof(prob, pcof)
    pcof = pcof.detach()
    n_seg = _segment_count(prob, n_segments, pcof.shape[0])
    m = order // 2
    _, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    work = _Work(prob, P, Q, m, refine_sweeps, use_kernels,
                 prob.solver == "schulz")
    if n_seg == prob.nsteps:
        traj, guard = _l1_forward(work)
        w_final = traj[:, -1]
    else:
        w_final, guard, _ = _snapshot_pass(work, n_seg, keep=False)
    j1 = terminal_cost(w_final.to(torch.float64),
                       target_on_device(prob, target), prob.N_ess_levels,
                       cost_type, ic_group)
    val = (j1 + ic_sum(guard, ic_group)
           + ridge_penalty(pcof, ridge_penalty_strength))
    return val[0] if single else val
