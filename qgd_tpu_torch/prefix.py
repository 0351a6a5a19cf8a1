"""Prefix-product propagation: the single-run latency route (counterpart
of ``qgd_tpu.prefix``).

After hoisting, each Hermite step is a fixed linear map::

    w_{n+1} = Xeff(t_{n+1}) R(t_n) w_n  =:  F_n w_n

with ``R`` the explicit-side matrix and ``Xeff`` the refined stage inverse
(the arithmetic :func:`~qgd_tpu_torch.ops.linalg.inverse_stage_solve`
applies to vectors, folded into a matrix: ``Xeff = (sum_i (I - X M)^i)
X``). A segment's states are then prefix products ``F_{k-1} ... F_0
w_start``, formed by a log-depth associative scan of batched ``(n, n)``
matmuls instead of L serial solves. The backward multipliers are the same
scan over affine maps::

    lam_k = B_k lam_{k+1} + g_k,   B_k = Xeff(t_k)^T R(t_k)^T,
                                   g_k = Xeff(t_k)^T f_k (guard forcing)

with the combine ``(A2, b2) o (A1, b1) = (A2 A1, A2 b1 + b2)``. Segments
of L steps run one after another and bound the live ``(S·L, n, n)``
tensors (:func:`_check_memory`). Gradient semantics are those of
``segmented.py``: the same terminal condition, merged cotangents and one
table-VJP pass over all time points after the segment sweep.

Kernels: a segment's ``R(t_left)`` and ``M(t_right)`` are LHS-kernel
launches at batch S·L (sign +1 and -1) in f32; the backward's left-end
pair ``(R, L)`` is one pair-kernel launch at the same batch. The prefix
products are plain matmuls, as in JAX, where they sit
outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from .controls import as_control_tuple, control_tables, control_tables_at
from .forward import (
    _PRECOMPUTE_BYTES_LIMIT,
    _hoisted_stage_pairs,
    _scenario_pcof,
    _stage_matrices,
    _time_grid,
    _warm_budget,
)
from .objective import (
    ic_sum,
    ridge_penalty,
    target_on_device,
    terminal_cost,
    terminal_cost_and_grad,
)
from .ops.linalg import REFINE_SWEEPS_F32, schulz_inverse_auto
from .segmented import (
    _Work,
    _cot_weights,
    _table_cotangents,
    _terminal_multiplier,
    choose_segments,
)


def _eff_inverses(wprob, M, X_drift=None, refine: int | None = None):
    """Effective stage inverses ``Xeff (..., n, n)`` of ``M``: the exact
    inverse in f64; in f32 the warm-started Newton-Schulz inverse ``X``
    with ``refine`` refinement sweeps folded in, ``Xeff = (sum_{i<=r}
    E^i) X``, ``E = I - X M`` (Horner). ``Xeff^T`` is the transposed
    refinement operator, so one tensor serves both sweeps."""
    if M.dtype == torch.float64:
        return torch.linalg.inv_ex(M)[0]
    X = schulz_inverse_auto(M, wprob.schulz_iters, X0=X_drift,
                            warm_iters=_warm_budget(wprob)).to(M.dtype)
    r = REFINE_SWEEPS_F32 if refine is None else refine
    if r == 0:
        return X
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    E = eye - X @ M
    S = eye + E
    for _ in range(r - 1):
        S = eye + E @ S
    return S @ X


def _associative_scan(fn, elems):
    """Inclusive scan of the tuple of tensors ``elems`` along dimension 1
    with the associative ``fn(earlier, later)``: the odd/even recursion of
    ``jax.lax.associative_scan`` (log-depth, O(L) combines), in its order
    of combination."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = fn(tuple(e[:, 0:-1:2] for e in elems),
                 tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:, :-1] for e in odd),
                  tuple(e[:, 2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[:, 2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        res = torch.empty_like(e)
        res[:, 0] = e[:, 0]
        res[:, 2::2] = ev
        res[:, 1::2] = od
        out.append(res)
    return tuple(out)


def _prefix_states(F_seg, w_start):
    """In-segment history by matrix prefix products: ``F_seg (S, L, n,
    n)``, ``w_start (S, n, B)`` -> ``(S, L+1, n, B)`` (index 0 =
    ``w_start``)."""
    (Pref,) = _associative_scan(lambda a, b: (b[0] @ a[0],), (F_seg,))
    return torch.cat([w_start[:, None], Pref @ w_start[:, None]], dim=1)


def _affine_prefix_lams(B_seg, g_seg, lam_b):
    """In-segment multipliers by affine prefix products. ``B_seg (S, L, n,
    n)`` and ``g_seg (S, L, n, B)`` are indexed by the segment's steps
    ``a..b-1``, ``lam_b (S, n, B)`` is the multiplier at its right edge.
    Returns ``(S, L+1, n, B)`` with index i holding ``lam_{a+i}``."""

    def comb(x, y):
        A1, b1 = x
        A2, b2 = y
        return A2 @ A1, A2 @ b1 + b2

    # application order: k = b-1 first (adjacent to lam_b)
    A, bb = _associative_scan(comb, (B_seg.flip(1), g_seg.flip(1)))
    lams = A @ lam_b[:, None] + bb                 # lams[:, i] = lam_{b-1-i}
    return torch.cat([lams.flip(1), lam_b[:, None]], dim=1)


def _segment_maps(work, a: int, b: int, need_left: bool):
    """Step maps ``F_seg (S, L, n, n)`` of steps ``a..b-1``; with
    ``need_left`` also ``R`` and ``Xeff`` at their left endpoints (the
    backward's affine maps), else ``None`` for both."""
    wprob, m, dt = work.wprob, work.m, work.dt
    Pw, Qw = work.Pw, work.Qw
    if need_left:
        R_left, M_left = _hoisted_stage_pairs(wprob, m, dt, Pw[:, a:b],
                                              Qw[:, a:b], work.use_kernels)
        Xeff_left = _eff_inverses(wprob, M_left, work.X0, work.sweeps)
        del M_left
    else:
        R_left = _stage_matrices(wprob, m, dt, Pw[:, a:b], Qw[:, a:b], 1.0,
                                 work.use_kernels)
        Xeff_left = None
    M_right = _stage_matrices(wprob, m, dt, Pw[:, a + 1:b + 1],
                              Qw[:, a + 1:b + 1], -1.0, work.use_kernels)
    F_seg = _eff_inverses(wprob, M_right, work.X0, work.sweeps) @ R_left
    return F_seg, (R_left if need_left else None), Xeff_left


# Live (S·L, n, n) tensors per step at the backward's peak: R and Xeff at
# the left ends with one Horner temporary, the right end's m-level stage
# stack and its matrix, Xeff there, the step maps, and the scan's levels
# (at most the input's size again).
def _live_per_step(m: int) -> int:
    return m + 7


def _check_memory(prob, S: int, L: int, m: int):
    """Refuse a segment length whose hoisted ``(S·L, n, n)`` tensors would
    exceed the cap of the plain route's hoisting (``QGD_HOIST_CAP_BYTES``,
    1.5 GB by default)."""
    n = prob.real_system_size
    itemsize = 4 if prob.dtype == "float32" else 8
    need = _live_per_step(m) * S * L * n * n * itemsize
    if need > _PRECOMPUTE_BYTES_LIMIT:
        raise ValueError(
            f"prefix route: segments of L={L} steps for {S} scenarios hold "
            f"~{need / 1e9:.2f} GB of (S*L, {n}, {n}) stage tensors "
            f"({_live_per_step(m)} per step), over the "
            f"{_PRECOMPUTE_BYTES_LIMIT / 1e9:.2f} GB cap "
            f"(QGD_HOIST_CAP_BYTES): pass a larger n_segments")


def _prefix_setup(prob, controls, pcof, order, n_segments, refine_sweeps,
                  use_kernels, with_leaf: bool):
    """``(work, pcof (S, N_params), single, n_seg, leaf, P, Q)``: the
    shared set-up of the three entry points."""
    controls = as_control_tuple(controls)
    pcof, single = _scenario_pcof(prob, pcof)
    pcof = pcof.detach()
    T, m = prob.nsteps, order // 2
    n_seg = (n_segments if n_segments > 0
             else choose_segments(T, target_len=max(256, int(T ** 0.5))))
    if T % n_seg:
        raise ValueError(f"n_segments={n_seg} must divide nsteps={T}")
    _check_memory(prob, pcof.shape[0], T // n_seg, m)
    _, ts = _time_grid(prob)
    with torch.enable_grad():
        leaf = pcof.clone().requires_grad_(with_leaf)
        P, Q = control_tables(controls, leaf, ts, m)
    # every f32 effective inverse is a warm-started Newton-Schulz inverse,
    # whatever the solver (f64 takes exact inverses)
    work = _Work(prob, P, Q, m, refine_sweeps, use_kernels,
                 prob.work_dtype == torch.float32)
    return work, pcof, single, n_seg, leaf, P, Q


def _forward_pass(work, n_seg: int, keep):
    """``(w_final, guard, starts)`` by prefix products; ``keep`` is
    ``"starts"`` (segment-start states ``(S, n_seg, n, B)``), ``"all"``
    (the whole history ``(S, T+1, n, B)``) or ``None``."""
    T = work.prob.nsteps
    L = T // n_seg
    w = work.wprob.w0.expand(work.Pw.shape[0], -1, -1)
    S = w.shape[0]
    shape = {"starts": (S, n_seg), "all": (S, T + 1)}.get(keep)
    kept = (None if shape is None else
            torch.empty(shape + tuple(w.shape[1:]), dtype=w.dtype,
                        device=w.device))
    guard = torch.zeros(S, dtype=torch.float64, device=w.device)
    for k in range(n_seg):
        a, b = k * L, (k + 1) * L
        F_seg, _, _ = _segment_maps(work, a, b, need_left=False)
        hist = _prefix_states(F_seg, w)
        del F_seg
        if keep == "starts":
            kept[:, k] = w
        elif keep == "all":
            kept[:, a:b] = hist[:, :-1]
        guard = guard + work.guard_part(hist[:, :-1], a)
        w = hist[:, -1]
    if keep == "all":
        kept[:, T] = w
    guard = guard + work.guard_part(w[:, None], T)
    return w, guard * work.dt64 / work.prob.tf, kept


def prefix_objective_and_gradient(prob, controls, pcof, target,
                                  order: int = 4,
                                  cost_type: str = "Infidelity",
                                  ridge_penalty_strength: float = 0.0,
                                  n_segments: int = 0, *,
                                  use_kernels: bool = True,
                                  refine_sweeps: int | None = None,
                                  ic_group=None):
    """Objective parts and Lagrange gradient with log-depth in-segment
    propagation: the ``((j1, guard, ridge), grad)`` of
    :func:`~qgd_tpu_torch.segmented.segmented_objective_and_gradient`,
    for ``pcof (S, N_params)`` or ``(N_params,)``. ``n_segments=0`` picks
    a segment length near ``max(256, sqrt(T))``. ``refine_sweeps`` sets
    the sweeps folded into the f32 effective inverses (default
    :data:`REFINE_SWEEPS_F32`); f64 takes exact inverses. ``ic_group``
    sums the infidelity's traces, the guard and the gradient over the
    ranks that hold the other gate columns, as the segmented route does."""
    controls = as_control_tuple(controls)
    work, pcof, single, n_seg, leaf, P, Q = _prefix_setup(
        prob, controls, pcof, order, n_segments, refine_sweeps, use_kernels,
        with_leaf=True)
    T, m, wd = prob.nsteps, work.m, work.wd
    L = T // n_seg

    # ---------------- forward: segment starts, guard penalty --------------
    w_final, guard, starts = _forward_pass(work, n_seg, keep="starts")
    w_final64 = w_final.to(torch.float64)
    j1, dj1 = terminal_cost_and_grad(w_final64, target_on_device(prob, target),
                                     prob.N_ess_levels, cost_type, ic_group)
    guard = ic_sum(guard, ic_group)
    ridge = ridge_penalty(pcof, ridge_penalty_strength)

    # ---------------- terminal condition (as segmented.py) ----------------
    g_T = dj1 + (work.dt64 / prob.tf) * (prob.guard_subspace_projector
                                         @ w_final64)
    p_f, q_f = control_tables_at(controls, pcof, prob.tf, m)
    p_f, q_f = p_f.to(wd), q_f.to(wd)
    lam_T = _terminal_multiplier(work, p_f, q_f, g_T,
                                 wd == torch.float32 or work.schulz)

    # ---------------- backward over segments ------------------------------
    # The sweep keeps the multipliers and states of every step (O(T)
    # vectors, no matrices) and leaves the table VJPs to one pass over
    # all time points afterwards, as in JAX.
    S = pcof.shape[0]
    lam = torch.empty((S, T + 2) + tuple(lam_T.shape[1:]), dtype=wd,
                      device=prob.device)
    states = torch.empty((S, T + 1) + tuple(lam_T.shape[1:]), dtype=wd,
                         device=prob.device)
    lam[:, T], lam[:, T + 1], states[:, T] = lam_T, 0.0, w_final
    lam_b = lam_T
    for k in range(n_seg - 1, -1, -1):
        a, b = k * L, (k + 1) * L
        F_seg, R_left, Xeff_left = _segment_maps(work, a, b,
                                                 need_left=True)
        hist = _prefix_states(F_seg, starts[:, k])   # re-forward
        del F_seg
        XT = Xeff_left.transpose(-1, -2)
        B_seg = XT @ R_left.transpose(-1, -2)
        del R_left, Xeff_left
        g_seg = XT @ work.forcing(hist[:, :-1], a)
        lam_seg = _affine_prefix_lams(B_seg, g_seg, lam_b)
        if k == 0:
            lam_seg[:, 0] = 0.0     # the initial state is fixed
        lam[:, a:b] = lam_seg[:, :-1]
        states[:, a:b] = hist[:, :-1]
        lam_b = lam_seg[:, 0]

    # ---------------- one table-VJP pass, then the pcof chain rule --------
    w_rhs, w_lhs = _cot_weights(m, work.dt64, wd, prob.device)
    P_cot = torch.cat([work.Pw[:, :T], p_f[:, None]], dim=1)
    Q_cot = torch.cat([work.Qw[:, :T], q_f[:, None]], dim=1)
    cotP, cotQ = _table_cotangents(work.wprob, m, w_rhs, w_lhs, P_cot,
                                   Q_cot, lam, states)
    (grad,) = torch.autograd.grad(
        (P, Q), leaf, (cotP.to(torch.float64), cotQ.to(torch.float64)))
    grad = ic_sum(grad, ic_group)
    grad = grad + 2.0 * ridge_penalty_strength * pcof / pcof.shape[-1]
    if single:
        return (j1[0], guard[0], ridge[0]), grad[0]
    return (j1, guard, ridge), grad


def prefix_objective_value(prob, controls, pcof, target, order: int = 4,
                           cost_type: str = "Infidelity",
                           ridge_penalty_strength: float = 0.0,
                           n_segments: int = 0, *,
                           use_kernels: bool = True,
                           refine_sweeps: int | None = None):
    """Value only by prefix products: ``j1 + guard + ridge``, ``(S,)``
    float64 (a scalar for a 1-D ``pcof``); the line-search probe of
    ``optimize_gate_multistart(gradient_route="prefix")``."""
    work, pcof, single, n_seg, _, _, _ = _prefix_setup(
        prob, controls, pcof, order, n_segments, refine_sweeps, use_kernels,
        with_leaf=False)
    w_final, guard, _ = _forward_pass(work, n_seg, keep=None)
    j1 = terminal_cost(w_final.to(torch.float64),
                       target_on_device(prob, target), prob.N_ess_levels,
                       cost_type)
    val = j1 + guard + ridge_penalty(pcof, ridge_penalty_strength)
    return val[0] if single else val


def eval_forward_prefix(prob, controls, pcof, order: int = 4,
                        n_segments: int = 0, *, use_kernels: bool = True):
    """Forward history ``(S, T+1, 2N, B)`` (``(T+1, 2N, B)`` for a 1-D
    ``pcof``) by prefix products, in the work dtype."""
    work, _, single, n_seg, _, _, _ = _prefix_setup(
        prob, controls, pcof, order, n_segments, None, use_kernels,
        with_leaf=False)
    _, _, hist = _forward_pass(work, n_seg, keep="all")
    return hist[0] if single else hist
