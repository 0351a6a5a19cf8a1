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
  endpoints (in f32 one pair-kernel launch at batch S·L; JAX builds the
  pair by XLA from one recursion), run the multiplier sweep
  ``L^T lam_n = R^T lam_{n+1} + f_n`` (``f_n`` the guard forcing, formed
  in f64) and contract the merged cotangents ``w_rhs lam_{n+1} - w_lhs
  lam_n`` against the operator basis into the control-table cotangents
  (:func:`_table_cot`: the VJP of the scaled-derivative stack with
  respect to the table values, by recursions on the basis products of
  the states and cotangents; no ``(2N, 2N)`` generator is formed). The
  pcof chain rule is one autograd pass through
  :func:`~qgd_tpu_torch.controls.control_tables` at the end.

Peak memory is O(n_segments + L) states plus one segment's ``(S·L, 2N,
2N)`` stage tensors. At L = 1 the stored segment starts ARE the
trajectory, so that route keeps the trajectory, makes no re-forward and
reads ``w_n`` straight from it; its backward builds each step's pair
``(R, L)`` in the step (the pair kernel at batch S in f32).

**Programs and CUDA graphs.** The step loops run as programs over static
buffers (:class:`_Programs`): at general L one segment's forward and one
segment's backward (:class:`_SegmentPrograms`), at L = 1 blocks of K
steps, K the divisor of ``nsteps`` nearest ``_BLOCK_STEPS``
(:class:`_BlockPrograms`: the forward writes the block's K states, the
backward its K multipliers' table cotangents from the stored states). The
host loads each span's tables, weights and incoming state or multiplier
into the buffers and runs the program. On a CUDA problem each program
runs eagerly once and is captured as a CUDA graph right after; every
later span replays it, so a span costs one graph launch and a few copies
on the host where the eager loops launch hundreds of operations per
step. The host-chunked route (:mod:`qgd_tpu_torch.chunked`) runs the same
segment programs for one control vector. A :class:`SegmentGraphs` keeps
the programs across calls (``graphs=``); a call without one captures its
own and replays them within the call. A capture or a replay that fails
raises; nothing runs eagerly in its place. Two rules are fixed by the
problem before any capture:

* ``solver="gmres"`` runs its programs eagerly on the card: its
  least-squares step (``ops.gmres._lstsq_min_norm``) is a
  ``torch.linalg.svd``, which copies to the host, and no graph can hold
  that copy. It steps each forward and re-forward through the GMRES stage
  (no stage matrix is built there); its backward sweep solves the
  transposed stage densely by LU, as the JAX package's does.
* ``solver="lu"`` factorizes by cuSOLVER while its programs run and are
  captured: at a batch of 128 x 128 matrices PyTorch's default is MAGMA's
  batched LU, which cannot be captured.

A CPU problem runs the same programs eagerly: that is the caller asking
for the CPU. A graph replay launches the kernels its capture recorded
without calling the kernel wrappers, so each replay adds its capture's
launches to the wrappers' counters (``ops.stage_kernels.add_launches``)
and the capture, which launches nothing, adds none: the counters read the
launches made.

While a profiler records, spans (:mod:`qgd_tpu_torch.tracing`) name a
call's phases and each program run after the capturing one in its trace.
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
import time

import torch

from .controls import as_control_tuple, control_tables, control_tables_at
from .forward import (
    _chunks,
    _time_grid,
    _scenario_pcof,
    _warm_budget,
    _drift_stage_inverse,
    _forward_segment_scan,
    _hoisted_inverses,
    _hoisted_stage_pairs,
    _make_preconditioner,
    _stage_matrices_both,
    _step_states,
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
from .ops import stage_kernels as sk
from .ops.linalg import (
    REFINE_SWEEPS_F32,
    factorize_stages,
    schulz_inverse_auto,
    inverse_stage_solve,
    solve_factored,
    stage_solve_transposed,
)
from .problem import working_problem
from .tracing import span

# Budget of the stored states on the card for the automatic segment rule
# (GB), read once at import, as in the JAX package.
_SEG_STATE_BUDGET_GB = float(os.environ.get("QGD_SEG_STATE_BUDGET_GB", "4"))

# Steps per block of the L = 1 route's programs (_block_length): about a
# segment program's length in the chunked route, whose graphs of 100 steps
# capture in a fraction of a second.
_BLOCK_STEPS = 100

# Program sets a SegmentGraphs keeps: a line search probes at every batch
# size its shrinking set of starts takes, and each size is one set.
_MAX_PROGRAM_SETS = 4


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


def _block_length(nsteps: int) -> int:
    """The L = 1 route's block of steps: the divisor of ``nsteps`` nearest
    ``_BLOCK_STEPS``, the smaller on a tie, so that every block has the
    shape of the first and one captured program serves them all."""
    return min(_divisors(nsteps), key=lambda d: (abs(d - _BLOCK_STEPS), d))


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


def _basis_products(ops, x):
    """The products of the C operators ``ops (N, C·N)`` (column block c
    the transpose of operator c) with both halves of ``x (R, B, 2N)``, a
    state's B columns as rows: ``(R, B, 2C, N)``, row ``h·C + c`` holding
    ``(op_c x_h)^T``. One product whose rows are every column of the batch."""
    R, B, n = x.shape
    return (x.reshape(-1, n // 2) @ ops).reshape(R, B, -1, n // 2)


def _level_rows(pt, qt, sign: int):
    """``(R, 1, m, 2, 4(N_ops+1))``: for each level k the two rows (u, v)
    that map the basis products of a state to ``A_k`` (``sign`` +1) or
    ``A_k^T`` (-1) times it, from the tables ``pt``, ``qt`` ``(R, m,
    N_ops+1)`` with the drift's coefficient last."""
    z = torch.zeros_like(pt)
    return torch.stack([torch.cat([z, qt, sign * pt, z], -1),
                        torch.cat([-sign * pt, z, z, qt], -1)], -2)[:, None]


def _table_cot(wprob, m: int, p, q, w, cot):
    """VJP of ``scaled_derivatives(assemble_generator_stack(p, q), w)`` with
    respect to the control-table values ``(p, q) (..., m, N_ops)`` at the
    states ``w (..., 2N, B)``, for the cotangent ``cot (..., m+1, 2N, B)``
    (all in one dtype, the basis's).

    Contracted through the operator basis: no ``(2N, 2N)`` generator is
    formed. With ``A_k = [[S_k, K_k], [-K_k, S_k]]`` (``S_k = delta_k0
    S_drift + sum_o q[k,o] asym_o``, ``K_k`` likewise from ``p`` and the
    symmetric operators), the forward recursion ``W_0 = w``, ``W_{j+1} =
    sum_{i<=j} A_{j-i} W_i / (j+1)`` (levels below m) applies each ``A_k``
    through the products of ``W_i`` with the stacked basis, and the reverse
    one ``Y_m = cot_m``, ``Y_j = cot_j + sum_{l>j} A_{l-1-j}^T Y_l / l``
    (levels m..1) through the products of ``Y_l / l`` with the transposed
    basis, ``G_l``. The cotangent of the table entry ``(k, o)`` is ``sum_l
    <G_l, W_{l-1-k}>`` over that entry's operator: ``<G_u, W_v> - <G_v,
    W_u>`` of ``sym_o`` for ``p``, ``<G_u, W_u> + <G_v, W_v>`` of
    ``asym_o`` for ``q``; at l = 1 the same inner products are taken as
    ``<Y_1, op W_0>`` from ``W_0``'s products, so ``G_1`` is never formed.
    States are held with their columns as rows, so each basis product is
    one matrix product over all of them. Plain products, no autograd:
    forward-mode tangents of every input flow through
    (``adjoint.eval_hessian``)."""
    batch = p.shape[:-2]
    R, (n, B), O = math.prod(batch), w.shape[-2:], p.shape[-1]
    p, q = p.reshape(R, m, O), q.reshape(R, m, O)
    w = w.reshape(R, n, B).mT.contiguous()
    cot = cot.reshape(R, m + 1, n, B)
    C = 2 * (O + 1)
    ops = torch.cat([wprob.sym_operators, wprob.system_sym[None],
                     wprob.asym_operators, wprob.system_asym[None]])
    basis = ops.permute(2, 0, 1).reshape(n // 2, -1)
    basis_t = ops.permute(1, 0, 2).reshape(n // 2, -1)
    delta = torch.eye(m, 1, dtype=p.dtype, device=p.device).expand(R, m, 1)
    pt, qt = torch.cat([p, delta], -1), torch.cat([q, delta], -1)
    rows, rows_t = _level_rows(pt, qt, 1), _level_rows(pt, qt, -1)

    # forward: W_{i+1..m-1} gain A_t W_i from W_i's products
    P0 = _basis_products(basis, w)
    Ws, acc = [w], [None] * m
    for i in range(m - 1):
        P_i = _basis_products(basis, Ws[i]) if i else P0
        part = (rows[:, :, :m - 1 - i].reshape(R, 1, -1, 2 * C)
                @ P_i).reshape(R, B, -1, n)
        for t in range(m - 1 - i):
            j = i + 1 + t
            acc[j] = (part[:, :, t] if acc[j] is None
                      else acc[j] + part[:, :, t])
        Ws.append(acc[i + 1] / (i + 1))
    # rows (k, h) of the slice [2(m-l):] hold W_{l-1-k}, k = 0..l-1
    W_rev = torch.stack(Ws[::-1], dim=2).reshape(R, B, 2 * m, -1)

    # reverse: Y_l / l through the transposed basis, contracted at each l
    # into dots[r, (h', c), (k, h)] = sum_l <G_l[h', c], W_{l-1-k}[h]>
    Y = [None] + list(cot[:, 1:].mT.contiguous().unbind(1))
    dots = None
    for l in range(m, 1, -1):
        G_l = _basis_products(basis_t, Y[l] / l)
        part = (rows_t[:, :, :l - 1].reshape(R, 1, -1, 2 * C)
                @ G_l).reshape(R, B, -1, n)
        for t in range(l - 1):
            Y[l - 1 - t] = Y[l - 1 - t] + part[:, :, t]
        cont = torch.nn.functional.pad(
            (G_l @ W_rev[:, :, 2 * (m - l):].mT).sum(1), (0, 2 * (m - l)))
        dots = cont if dots is None else dots + cont
    cont = (Y[1].reshape(R, B, 2, -1) @ P0.mT).sum(1)     # [h', (h, c)]
    cont = torch.nn.functional.pad(
        cont.reshape(R, 2, 2, C).transpose(-1, -2).reshape(R, 2 * C, 2),
        (0, 2 * (m - 1)))
    dots = (cont if dots is None else dots + cont).reshape(R, 2, C, m, 2)
    cotP = dots[:, 0, :O, :, 1] - dots[:, 1, :O, :, 0]
    cotQ = (dots[:, 0, O + 1:2 * O + 1, :, 0]
            + dots[:, 1, O + 1:2 * O + 1, :, 1])
    return cotP.mT.reshape(batch + (m, O)), cotQ.mT.reshape(batch + (m, O))


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


def _snapshot_pass(work, progs, n_seg: int, keep: bool):
    """The segmented forward, segment by segment through ``progs``
    (:class:`_SegmentPrograms`): ``(w_final, guard, starts)`` with the guard
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
        progs.load(work, k * L)
        progs.w.copy_(w)
        w, g = progs.run("fwd")
        guard = guard + g
    w = w.clone()                     # outlives the next replay
    guard = guard + work.guard_part(w[:, None], T)
    return w, guard * work.dt64 / work.prob.tf, starts


def _l1_forward(work, progs):
    """The L = 1 forward, block by block through ``progs``
    (:class:`_BlockPrograms`): ``(trajectory (S, T+1, 2N, B), guard)``."""
    T, K = work.prob.nsteps, progs.L
    w0 = work.wprob.w0.expand(work.Pw.shape[0], -1, -1)
    traj = torch.empty((w0.shape[0], T + 1) + tuple(w0.shape[1:]),
                       dtype=w0.dtype, device=w0.device)
    traj[:, 0] = w0
    for a in range(0, T, K):
        progs.load(work, a)
        progs.w.copy_(traj[:, a])
        traj[:, a + 1:a + K + 1] = progs.run("fwd")
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


def _sweep(lam_b, L: int, step, lam0_scale):
    """The multipliers ``(S, L+1, 2N, B)`` of a span of L steps, index i
    holding lambda at its step i: ``lam_b`` at L, then ``step(i,
    lambda_{i+1})`` for i = L-1 .. 0; ``lam0_scale`` multiplies index 0 (0
    for the span that starts at t_0, whose state is fixed)."""
    lam_seg = torch.empty((lam_b.shape[0], L + 1) + tuple(lam_b.shape[1:]),
                          dtype=lam_b.dtype, device=lam_b.device)
    lam_seg[:, L] = lam_b
    lam = lam_b
    for i in range(L - 1, -1, -1):
        lam = step(i, lam)
        lam_seg[:, i] = lam
    lam_seg[:, 0] *= lam0_scale
    return lam_seg


def _block_backward_step(work, states, lam_b, X0T, w_rhs, w_lhs,
                         lam0_scale):
    """One block of the L = 1 backward over the tables of ``work`` (its
    first L+1 time points): the multiplier sweep from ``lam_b`` (lambda at
    the block's right end), each step's pair ``(R, L)`` built in the step,
    and the table cotangents ``(S, L, m, N_ops)`` at the block's L left
    endpoints, whose states are ``states (S, L, 2N, B)``. Returns
    ``(lambda at the block's first step, cotP, cotQ)``."""
    prob, m, L = work.prob, work.m, states.shape[1]
    f = work.forcing(states, 0)
    warm = _warm_budget(work.wprob)

    def step(i, lam):
        R, Lm = _stage_matrices_both(work.wprob, m, work.dt, work.Pw[:, i],
                                     work.Qw[:, i], work.use_kernels)
        mu = R.transpose(-1, -2) @ lam + f[:, i]
        if work.schulz:
            LT = Lm.transpose(-1, -2)
            XT = schulz_inverse_auto(LT, prob.schulz_iters, X0=X0T,
                                     warm_iters=warm)
            return inverse_stage_solve(LT, XT, mu, work.sweeps)
        return stage_solve_transposed(Lm, mu)

    lam_seg = _sweep(lam_b, L, step, lam0_scale)
    cotP, cotQ = _table_cotangents(work.wprob, m, w_rhs, w_lhs,
                                   work.Pw[:, :L], work.Qw[:, :L], lam_seg,
                                   states)
    return lam_seg[:, 0], cotP, cotQ


def _l1_backward(work, progs, traj, lam_T, w_rhs, w_lhs, p_f, q_f):
    """The L = 1 backward, block by block through ``progs``
    (:class:`_BlockPrograms`) reading the stored trajectory: the table
    cotangents ``(S, T+1, m, N_ops)``."""
    m, T, K = work.m, work.prob.nsteps, progs.L
    cotP = torch.empty((work.Pw.shape[0], T + 1) + tuple(work.Pw.shape[2:]),
                       dtype=work.wd, device=work.Pw.device)
    cotQ = torch.empty_like(cotP)
    lam = lam_T
    for a in range(T - K, -1, -K):
        progs.load(work, a)
        progs.states.copy_(traj[:, a:a + K])
        progs.lam.copy_(lam)
        lam, cotP[:, a:a + K], cotQ[:, a:a + K] = progs.run("bwd")
    # terminal index T: only the LHS term survives (no step starts at T)
    cotP[:, T], cotQ[:, T] = _table_cot(work.wprob, m, p_f, q_f, traj[:, T],
                                        -w_lhs * lam_T[:, None])
    return cotP, cotQ


def _segment_backward_step(work, a: int, b: int, w_start, lam_b, X0T,
                           w_rhs, w_lhs, lam0_scale):
    """One segment of the general-L backward (module docstring), steps
    ``a..b``: re-forward from ``w_start``, the multiplier sweep from
    ``lam_b`` (lambda at step b) and the table cotangents ``(S, L, m,
    N_ops)`` at the segment's L left endpoints. ``lam0_scale`` multiplies
    lambda at step a before the cotangents are formed (0 for the segment
    that starts at t_0, whose state is fixed). Returns ``(lambda_a, cotP,
    cotQ)``."""
    m, L = work.m, b - a
    hist = work.segment(a, b, w_start)                       # re-forward
    f_seg = work.forcing(hist[:, :-1], a)
    R, Lm = _hoisted_stage_pairs(work.wprob, m, work.dt, work.Pw[:, a:b],
                                 work.Qw[:, a:b], work.use_kernels)
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

    lam_seg = _sweep(lam_b, L, lambda i, lam: solve(
        i, R[:, i].transpose(-1, -2) @ lam + f_seg[:, i]), lam0_scale)
    cotP, cotQ = _table_cotangents(work.wprob, m, w_rhs, w_lhs,
                                   work.Pw[:, a:b], work.Qw[:, a:b], lam_seg,
                                   hist)
    return lam_seg[:, 0], cotP, cotQ


def _segment_backward(work, progs, n_seg: int, starts, w_final, lam_T,
                      w_rhs, w_lhs, p_f, q_f):
    """The general-L backward (module docstring), segment by segment in
    reverse through ``progs`` (:class:`_SegmentPrograms`): the table
    cotangents ``(S, T+1, m, N_ops)``."""
    m, T = work.m, work.prob.nsteps
    L = T // n_seg
    cotP = torch.empty((work.Pw.shape[0], T + 1) + tuple(work.Pw.shape[2:]),
                       dtype=work.wd, device=work.Pw.device)
    cotQ = torch.empty_like(cotP)
    lam_b = lam_T
    for k in range(n_seg - 1, -1, -1):
        a = k * L
        progs.load(work, a)
        progs.w.copy_(starts[:, k])
        progs.lam.copy_(lam_b)
        lam_b, cotP[:, a:a + L], cotQ[:, a:a + L] = progs.run("bwd")
    # terminal index T: only the LHS term survives (no step starts at T)
    cotP[:, T], cotQ[:, T] = _table_cot(work.wprob, m, p_f, q_f, w_final,
                                        -w_lhs * lam_T[:, None])
    return cotP, cotQ


def _captures(prob) -> bool:
    """Whether the programs of ``prob`` run as CUDA graphs: on a CUDA
    problem, unless ``solver="gmres"`` (module docstring)."""
    return prob.device.type == "cuda" and prob.solver != "gmres"


@contextlib.contextmanager
def _capturable_linalg(prob):
    """cuSOLVER for the LU factorizations of an ``"lu"`` problem's
    programs while they run eagerly and are captured (module docstring);
    PyTorch's choice is restored after."""
    if prob.solver != "lu":
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


class _Programs:
    """The forward and backward programs (``"fwd"``, ``"bwd"``, defined by
    a subclass) of a span of ``L`` steps of ``S`` scenarios of ``prob`` at
    half-order ``m``, over static buffers, with the call's refinement
    sweeps and kernel routing.

    Inputs, written by the caller before each run (:meth:`load` writes the
    tables, weights and ``lam0_scale`` of a span of a whole-horizon
    :class:`_Work`): ``P``, ``Q`` ``(S, L+1, m, N_ops)`` (the work dtype)
    the tables at the span's L+1 time points; ``tau (L+1,)`` the trapezoid
    weights at them (f64); ``w`` the start state and ``lam`` the multiplier
    at the span's right end, ``(S, 2N, B)``; ``lam0_scale`` 0 for the span
    that starts at t_0, else 1. On the card a run's outputs live in the
    graph's memory until its next replay.
    """

    def __init__(self, prob, m: int, L: int, S: int = 1,
                 refine_sweeps=None, use_kernels: bool = True):
        dev, wd = prob.device, prob.work_dtype
        self.L = L
        self.P = torch.zeros((S, L + 1, m, prob.N_operators), dtype=wd,
                             device=dev)
        self.Q = torch.zeros_like(self.P)
        self.tau = torch.ones(L + 1, dtype=torch.float64, device=dev)
        self.w = torch.zeros((S, prob.real_system_size,
                              prob.N_initial_conditions), dtype=wd,
                             device=dev)
        self.lam = torch.zeros_like(self.w)
        self.lam0_scale = torch.ones((), dtype=wd, device=dev)
        self.work = _Work(prob, self.P, self.Q, m, refine_sweeps,
                          use_kernels, prob.solver == "schulz", tau=self.tau)
        self.w_rhs, self.w_lhs = _cot_weights(m, self.work.dt64, wd, dev)
        self.X0T = (_drift_stage_inverse(self.work.wprob, m, self.work.dt,
                                         transpose=True)
                    if self.work.schulz else None)
        self.captures = _captures(prob)
        self.graphs = {}          # kind -> (graph, outputs, launches)
        self.capture_seconds = 0.0
        self.replays = {"fwd": 0, "bwd": 0}

    def load(self, work, a: int):
        """The tables and weights of the span starting at step ``a`` of
        ``work`` (the call's whole-horizon :class:`_Work`) into the
        buffers, and its ``lam0_scale``."""
        b = a + self.L + 1
        self.P.copy_(work.Pw[:, a:b])
        self.Q.copy_(work.Qw[:, a:b])
        self.tau.copy_(work.tau[a:b])
        self.lam0_scale.fill_(0.0 if a == 0 else 1.0)

    def run(self, kind: str):
        """Run program ``kind`` (``"fwd"``/``"bwd"``) on the buffers'
        contents. On the card: the first run executes eagerly and captures
        the program; every later run replays the graph."""
        fn = self._forward if kind == "fwd" else self._backward
        if not self.captures:
            with span("qgd.replay." + kind):
                return fn()
        if kind not in self.graphs:
            with _capturable_linalg(self.work.prob):
                out = fn()
                t0 = time.perf_counter()
                self.graphs[kind] = self._capture(fn)
                self.capture_seconds += time.perf_counter() - t0
            return out
        graph, outputs, launches = self.graphs[kind]
        with span("qgd.replay." + kind):
            graph.replay()
            sk.add_launches(launches)
        self.replays[kind] += 1
        return outputs

    @staticmethod
    def _capture(fn):
        """``(graph, outputs, launches)``: one call of ``fn`` captured. The
        capture runs no kernel, so the launches its wrappers counted are
        taken off the counters and added back at each replay."""
        before = sk.launch_tally()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = fn()
        launches = {k: n - before[k] for k, n in sk.launch_tally().items()}
        sk.add_launches(launches, -1)
        return graph, outputs, launches


class _SegmentPrograms(_Programs):
    """One segment of the general-L route: ``"fwd"`` returns ``(w_end,
    guard_partial (S,) f64)`` from ``w``; ``"bwd"`` returns
    ``(lambda_start, cotP, cotQ)`` from ``w`` and ``lam``
    (:func:`_segment_backward_step`)."""

    def _forward(self):
        hist = self.work.segment(0, self.L, self.w)
        return hist[:, -1], self.work.guard_part(hist[:, :-1], 0)

    def _backward(self):
        return _segment_backward_step(self.work, 0, self.L, self.w,
                                      self.lam, self.X0T, self.w_rhs,
                                      self.w_lhs, self.lam0_scale)


class _BlockPrograms(_Programs):
    """A block of ``L`` steps of the L = 1 route, whose states are kept:
    ``"fwd"`` returns the states after each of the block's steps ``(S, L,
    2N, B)`` from ``w``; ``"bwd"`` returns ``(lambda at the block's first
    step, cotP, cotQ)`` from ``lam`` and the buffer ``states (S, L, 2N,
    B)``, the stored states at the block's L left endpoints
    (:func:`_block_backward_step`)."""

    def __init__(self, prob, m: int, L: int, S: int = 1,
                 refine_sweeps=None, use_kernels: bool = True):
        super().__init__(prob, m, L, S, refine_sweeps, use_kernels)
        self.states = torch.zeros((S, L) + tuple(self.w.shape[1:]),
                                  dtype=self.w.dtype, device=self.w.device)

    def _forward(self):
        work = self.work
        out = torch.empty_like(self.states)
        for k, w in enumerate(_step_states(
                work.wprob, work.m, work.dt, work.Pw, work.Qw, work.X0,
                work.use_kernels, work.sweeps, precond=work.precond,
                w_start=self.w)):
            out[:, k] = w
        return out

    def _backward(self):
        return _block_backward_step(self.work, self.states, self.lam,
                                    self.X0T, self.w_rhs, self.w_lhs,
                                    self.lam0_scale)


class SegmentGraphs:
    """Programs (:class:`_SegmentPrograms`, :class:`_BlockPrograms`) kept
    across calls, each set captured once on the card: one per program
    class, problem (by identity: its tensors are the graphs' constants),
    mesh, half-order, span length, batch, refinement sweeps and kernel
    routing. At most ``_MAX_PROGRAM_SETS`` sets are kept, the least
    recently used dropped first. ``optimize_gate`` and
    ``optimize_gate_multistart`` make one per run; a call without one makes
    its own."""

    def __init__(self):
        self._programs = collections.OrderedDict()

    def programs(self, cls, prob, m: int, L: int, S: int = 1, *,
                 mesh=None, local_prob=None, refine_sweeps=None,
                 use_kernels: bool = True) -> _Programs:
        """The ``cls`` programs of ``local_prob`` (default ``prob``)."""
        key = (cls, id(prob), id(mesh), m, L, S, refine_sweeps, use_kernels)
        entry = self._programs.get(key)
        if entry is None:
            # the key's objects are held, so their ids stay theirs
            entry = (prob, mesh, cls(prob if local_prob is None
                                     else local_prob, m, L, S,
                                     refine_sweeps, use_kernels))
            self._programs[key] = entry
            while len(self._programs) > _MAX_PROGRAM_SETS:
                self._programs.popitem(last=False)
        self._programs.move_to_end(key)
        return entry[2]

    def stats(self) -> dict:
        """Graphs captured, their capture seconds and replays by kind, over
        the program sets kept."""
        progs = [e[2] for e in self._programs.values()]
        return {"graphs": sum(len(p.graphs) for p in progs),
                "capture_seconds": sum(p.capture_seconds for p in progs),
                "replays": {k: sum(p.replays[k] for p in progs)
                            for k in ("fwd", "bwd")}}


def _call_programs(graphs, prob, m: int, n_seg: int, S: int,
                   refine_sweeps, use_kernels: bool) -> _Programs:
    """The programs a segmented call runs: blocks of ``_block_length(T)``
    steps at L = 1, segments of L steps otherwise, from ``graphs`` (a new
    :class:`SegmentGraphs` when ``None``)."""
    T = prob.nsteps
    graphs = SegmentGraphs() if graphs is None else graphs
    if n_seg == T:
        return graphs.programs(_BlockPrograms, prob, m, _block_length(T), S,
                               refine_sweeps=refine_sweeps,
                               use_kernels=use_kernels)
    return graphs.programs(_SegmentPrograms, prob, m, T // n_seg, S,
                           refine_sweeps=refine_sweeps,
                           use_kernels=use_kernels)


def segmented_objective_and_gradient(prob, controls, pcof, target,
                                     order: int = 4,
                                     cost_type: str = "Infidelity",
                                     ridge_penalty_strength: float = 0.0,
                                     n_segments: int = 0, *,
                                     use_kernels: bool = True,
                                     refine_sweeps: int | None = None,
                                     ic_group=None,
                                     graphs: SegmentGraphs | None = None):
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

    ``graphs``: the :class:`SegmentGraphs` to take the step loops'
    programs from and keep them in (captured once per problem, batch and
    span; a call without one captures its own).
    """
    with span("qgd.call"):
        controls = as_control_tuple(controls)
        pcof, single = _scenario_pcof(prob, pcof)
        pcof = pcof.detach()
        n_seg = _segment_count(prob, n_segments, pcof.shape[0])
        T, m = prob.nsteps, order // 2
        dt64, ts = _time_grid(prob)
        with span("qgd.tables"):
            with torch.enable_grad():
                pcof_leaf = pcof.clone().requires_grad_(True)
                P, Q = control_tables(controls, pcof_leaf, ts, m)
            work = _Work(prob, P, Q, m, refine_sweeps, use_kernels, False)
        wd = work.wd
        progs = _call_programs(graphs, prob, m, n_seg, pcof.shape[0],
                               refine_sweeps, use_kernels)

        # -------------- forward: final state, guard penalty ---------------
        with span("qgd.forward"):
            if n_seg == T:
                traj, guard = _l1_forward(work, progs)
                w_final = traj[:, T]
            else:
                w_final, guard, starts = _snapshot_pass(work, progs, n_seg,
                                                        keep=True)

        # -------------- terminal condition --------------------------------
        with span("qgd.terminal"):
            w_final64 = w_final.to(torch.float64)
            j1, dj1 = terminal_cost_and_grad(
                w_final64, target_on_device(prob, target), prob.N_ess_levels,
                cost_type, ic_group)
            guard = ic_sum(guard, ic_group)
            ridge = ridge_penalty(pcof, ridge_penalty_strength)
            g_T = dj1 + (dt64 / prob.tf) * (prob.guard_subspace_projector
                                             @ w_final64)
            p_f, q_f = control_tables_at(controls, pcof, prob.tf, m)
            p_f, q_f = p_f.to(wd), q_f.to(wd)
            lam_T = _terminal_multiplier(work, p_f, q_f, g_T, work.schulz)

        # -------------- backward, table cotangents, pcof chain rule -------
        with span("qgd.backward"):
            w_rhs, w_lhs = _cot_weights(m, dt64, wd, prob.device)
            if n_seg == T:
                cotP, cotQ = _l1_backward(work, progs, traj, lam_T, w_rhs,
                                          w_lhs, p_f, q_f)
            else:
                cotP, cotQ = _segment_backward(work, progs, n_seg, starts,
                                               w_final, lam_T, w_rhs, w_lhs,
                                               p_f, q_f)
        with span("qgd.table_vjp"):
            (grad,) = torch.autograd.grad(
                (P, Q), pcof_leaf,
                (cotP.to(torch.float64), cotQ.to(torch.float64)))
            grad = ic_sum(grad, ic_group)
            grad = (grad + 2.0 * ridge_penalty_strength * pcof
                    / pcof.shape[-1])

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
                              ic_group=None,
                              graphs: SegmentGraphs | None = None):
    """Value only (one forward pass, no adjoint work): ``j1 + guard +
    ridge``, ``(S,)`` float64 (a scalar for a 1-D ``pcof``). The line-search
    probe of ``optimize_gate_multistart(gradient_route="segmented")``; both
    kernels run at batch S (the LHS kernel at S·L per segment).
    ``ic_group`` and ``graphs`` as in
    :func:`segmented_objective_and_gradient`, whose forward programs this
    runs."""
    with span("qgd.call"):
        controls = as_control_tuple(controls)
        pcof, single = _scenario_pcof(prob, pcof)
        pcof = pcof.detach()
        n_seg = _segment_count(prob, n_segments, pcof.shape[0])
        m = order // 2
        _, ts = _time_grid(prob)
        with span("qgd.tables"):
            P, Q = control_tables(controls, pcof, ts, m)
            work = _Work(prob, P, Q, m, refine_sweeps, use_kernels, False)
        progs = _call_programs(graphs, prob, m, n_seg, pcof.shape[0],
                               refine_sweeps, use_kernels)
        with span("qgd.forward"):
            if n_seg == prob.nsteps:
                traj, guard = _l1_forward(work, progs)
                w_final = traj[:, -1]
            else:
                w_final, guard, _ = _snapshot_pass(work, progs, n_seg,
                                                   keep=False)
        with span("qgd.terminal"):
            j1 = terminal_cost(w_final.to(torch.float64),
                               target_on_device(prob, target),
                               prob.N_ess_levels, cost_type, ic_group)
            val = (j1 + ic_sum(guard, ic_group)
                   + ridge_penalty(pcof, ridge_penalty_strength))
        return val[0] if single else val
