"""Forward and adjoint propagation of the implicit Hermite scheme
(counterpart of ``qgd_tpu.forward``). Scenarios are a leading dimension of
every tensor: a control-vector batch ``pcof (S, N_params)`` gives histories
``(S, T+1, 2N, B)``; a 1-D ``pcof`` gives ``(T+1, 2N, B)``.

The step loop is a Python loop with one host-side iteration per step and
no synchronisation inside it. What does not depend on the state is hoisted
out of it (:func:`_forward_segment_scan`): a segment's stage matrices,
built in one batched call, and their factorizations (``solver="lu"``) or
Newton-Schulz inverses (``solver="schulz"``). The plain route hoists the
whole horizon as one segment when it fits (:func:`_use_precomputed_stages`);
the thinned history (``eval_forward(save_every > 1)``) and the segmented
route run one segment at a time. ``solver="gmres"`` hoists nothing: each
step solves its stage matrix-free (``ops.gmres``) from the Taylor guess,
with the problem's preconditioner (``ops.preconditioners``), applying
the stage operator to the whole state block at once.

Kernel routing (``use_kernels=True``) follows the JAX package: the
implicit-stage matrices go through the LHS kernel where JAX uses its
Pallas kernel (f32, m >= 2, ``forward.py:135-148``; in the hoisted build
that is one launch at batch S·T), and the explicit half of a step goes
through the RHS kernel for f32 tensors (JAX computes that half with XLA
ops), as does every GMRES application of the stage operator (the RHS
kernel at step sign -1, JAX's ``apply_lhs``). The adjoint's pair ``(R,
L)`` of one-step matrices, which JAX builds by XLA from one recursion,
goes through the pair kernel under the LHS kernel's rule (one launch at
batch S·T' in the hoisted build). On the CPU the kernel wrappers run
their plain versions; ``use_kernels=False`` is the plain route
everywhere.
"""

from __future__ import annotations

import os
import warnings

import torch

from .controls import as_control_tuple, control_tables
from .ops.gmres import hermite_gmres_stage
from .ops.hermite import (
    assemble_generator_stack,
    scaled_derivatives,
    build_rhs,
    build_lhs,
    taylor_expand,
)
from .ops.linalg import (
    schulz_inverse_auto,
    inverse_stage_solve,
    factorize_stages,
    solve_factored,
    stage_solve,
    stage_solve_transposed,
)
from .ops.stage_kernels import (
    hermite_lhs_matrix_kernel_call,
    hermite_rhs_kernel_call,
    hermite_stage_pair_kernel_call,
    stage_pair_plain,
)
from .problem import working_problem

# Hoisting the per-step stage tensors out of the step loop costs
# _hoisted_per_step(m) * nsteps * (2N)^2 * itemsize bytes per scenario;
# cap it (QGD_HOIST_CAP_BYTES, read once at import, as in the JAX package).
_PRECOMPUTE_BYTES_LIMIT = int(
    os.environ.get("QGD_HOIST_CAP_BYTES", 1_500_000_000))

# Scenario-steps per chunk of the batched builds that are not one kernel
# launch (plain stage builds, Schulz inverses, table VJPs, guard sums):
# bounds their temporaries (about 0.6 MB per scenario-step at 2N = 128,
# m = 2, f32).
_STEP_CHUNK = 2048


def _chunks(T: int, S: int):
    """``(a, b)`` ranges covering ``0..T`` with at most ``_STEP_CHUNK``
    scenario-steps each."""
    step = max(1, _STEP_CHUNK // max(S, 1))
    return [(a, min(a + step, T)) for a in range(0, T, step)]


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


def _hoisted_per_step(m: int) -> int:
    """Live ``(2N, 2N)`` tensors per step and scenario at the peak of the
    hoisted routes: the adjoint's one pair-kernel launch holds the m-level
    generator stack, R and L (m + 2); its sweep R, L and L's factors or
    inverse (3); the forward's one LHS-kernel launch the stack and its
    output (m + 1)."""
    return max(3, m + 2)


def _use_precomputed_stages(prob, m: int) -> str | None:
    """Which state-independent work to hoist out of the step loop:
    ``"full"`` (stage matrices and their LU factors, ``solver="lu"``),
    ``"schulz"`` (stage matrices and their warm-started Newton-Schulz
    inverses) or ``None``: build each step's stage inside the loop, when
    the hoisted tensors would exceed the cap, or solve it matrix-free
    (``solver="gmres"``, as in JAX). The estimate is multiplied by
    ``prob.hoist_batch_hint``, the number of scenarios batched."""
    if prob.solver == "gmres":
        return None
    n2 = prob.real_system_size
    itemsize = 4 if prob.dtype == "float32" else 8
    hint = max(int(prob.hoist_batch_hint), 1)
    need = _hoisted_per_step(m) * prob.nsteps * n2 * n2 * itemsize * hint
    if need > _PRECOMPUTE_BYTES_LIMIT:
        warnings.warn(
            f"qgd_tpu_torch: hoisted stage precompute disabled: it would "
            f"need ~{need / 1e9:.1f} GB (> {_PRECOMPUTE_BYTES_LIMIT / 1e9:.1f}"
            f" GB cap) for nsteps={prob.nsteps}, 2N={n2}, batch_hint={hint};"
            f" building each step's stage inside the step loop instead.",
            stacklevel=3)
        return None
    return "schulz" if prob.solver == "schulz" else "full"


def _lhs_kernel_applies(A_dtype, m: int, use_kernels: bool) -> bool:
    """The f32, m >= 2 implicit-stage build goes through the LHS kernel."""
    return use_kernels and m >= 2 and A_dtype == torch.float32


def _stage_from_stack(A, m: int, dt, sign: float, use_kernels: bool = True):
    """Dense one-step matrices ``sum_j (sign*dt)^j c_j D_j`` from generator
    stacks ``A (..., m, n, n)`` -> ``(..., n, n)`` (``_stage_matrices`` of
    the JAX package, on a stack the caller assembled). The f32, m >= 2
    build is one LHS-kernel launch over the whole batch."""
    if _lhs_kernel_applies(A.dtype, m, use_kernels):
        batch = A.shape[:-3]
        flat = A.reshape((-1,) + A.shape[-3:]).contiguous()
        out = hermite_lhs_matrix_kernel_call(flat, dt, m, sign)
        return out.reshape(batch + out.shape[-2:])
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return build_rhs(scaled_derivatives(A, eye, m), sign * dt, m)


def _stage_matrices(prob, m: int, dt, P, Q, sign: float,
                    use_kernels: bool = True):
    """Batched one-step matrices at the time points whose tables are
    ``P, Q (S, T', m, N_ops)`` -> ``(S, T', n, n)``: the hoisted,
    state-independent build. The generator stacks are assembled in chunks
    of time points; the f32 build is then one LHS-kernel launch at batch
    S·T' (the stacks, m per step, and the result alive together), the
    plain build runs chunk by chunk."""
    S, T = P.shape[:2]
    n = prob.real_system_size
    kernel = _lhs_kernel_applies(P.dtype, m, use_kernels)
    shape = (S, T, m, n, n) if kernel else (S, T, n, n)
    out = torch.empty(shape, dtype=P.dtype, device=P.device)
    for a, b in _chunks(T, S):
        A = assemble_generator_stack(prob, P[:, a:b], Q[:, a:b], m)
        out[:, a:b] = A if kernel else _stage_from_stack(A, m, dt, sign,
                                                         use_kernels=False)
    return _stage_from_stack(out, m, dt, sign, use_kernels) if kernel else out


def _pair_from_stack(A, m: int, dt, use_kernels: bool = True):
    """Both one-step matrices ``(RHS, LHS)`` from generator stacks ``A
    (..., m, n, n)``, each ``(..., n, n)``: one pair-kernel launch over the
    whole batch where the LHS kernel's rule takes the stack, else the
    plain recursion."""
    if not _lhs_kernel_applies(A.dtype, m, use_kernels):
        return stage_pair_plain(A, dt, m)
    batch = A.shape[:-3]
    flat = A.reshape((-1,) + A.shape[-3:]).contiguous()
    R, L = hermite_stage_pair_kernel_call(flat, dt, m)
    return (R.reshape(batch + R.shape[-2:]),
            L.reshape(batch + L.shape[-2:]))


def _stage_matrices_both(prob, m: int, dt, P, Q, use_kernels: bool = True):
    """Both one-step matrices ``(RHS, LHS)`` from one identity recursion
    at the time points whose tables are ``P, Q (..., m, N_ops)``: the pair
    kernel for f32 at m >= 2, plain torch otherwise (as JAX builds them)."""
    return _pair_from_stack(assemble_generator_stack(prob, P, Q, m), m, dt,
                            use_kernels)


def _rhs_kernel_applies(w_dtype, use_kernels: bool) -> bool:
    """The explicit half of an f32 step goes through the RHS kernel."""
    return use_kernels and w_dtype == torch.float32


def _explicit_half(A_n, w, dt, m: int, use_kernels: bool = True):
    """``build_rhs(scaled_derivatives(A_n, w), dt)`` for ``A_n (S, m, n,
    n)``, ``w (S, n, b)``; through the RHS kernel for f32 tensors."""
    if _rhs_kernel_applies(w.dtype, use_kernels):
        return hermite_rhs_kernel_call(A_n.contiguous(), w.contiguous(), dt,
                                       m)
    return build_rhs(scaled_derivatives(A_n, w, m), dt, m)


def _make_preconditioner(prob, dt, order: int):
    """The ``(apply, apply_T)`` pair of ``prob.preconditioner_type`` for the
    GMRES stage solve, or ``None`` (another solver, or ``"identity"``).
    ``prob`` is the problem as built (float64 operators), ``dt`` the float64
    step."""
    if prob.solver != "gmres" or prob.preconditioner_type == "identity":
        return None
    from .ops.preconditioners import PRECONDITIONERS

    return PRECONDITIONERS[prob.preconditioner_type](prob, dt, order)


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


def _hoisted_inverses(prob, m: int, dt, M, transpose: bool = False,
                      X0=None):
    """Warm-started Newton-Schulz inverses (f32) of the hoisted stage
    matrices ``M (S, T', n, n)``, built in chunks of time points. ``X0``,
    the drift-only inverse, is built here unless the caller hoisted it."""
    if X0 is None:
        X0 = _drift_stage_inverse(prob, m, dt, transpose)
    X = torch.empty(M.shape, dtype=torch.float32, device=M.device)
    for a, b in _chunks(M.shape[1], M.shape[0]):
        X[:, a:b] = schulz_inverse_auto(M[:, a:b], prob.schulz_iters, X0=X0,
                                        warm_iters=_warm_budget(prob))
    return X


def _hoisted_stage_pairs(prob, m: int, dt, P, Q, use_kernels: bool = True):
    """``(R, L)``, each ``(S, T', n, n)``: both one-step matrices at the time
    points whose tables are ``P, Q (S, T', m, N_ops)``. As in
    :func:`_stage_matrices`, the generator stacks are assembled in chunks
    of time points; the f32 build is then one pair-kernel launch at batch
    S·T', the plain build runs chunk by chunk."""
    S, T = P.shape[:2]
    n = prob.real_system_size
    if _lhs_kernel_applies(P.dtype, m, use_kernels):
        A = torch.empty((S, T, m, n, n), dtype=P.dtype, device=P.device)
        for a, b in _chunks(T, S):
            A[:, a:b] = assemble_generator_stack(prob, P[:, a:b], Q[:, a:b],
                                                 m)
        return _pair_from_stack(A, m, dt)
    R = torch.empty((S, T, n, n), dtype=P.dtype, device=P.device)
    L = torch.empty_like(R)
    for a, b in _chunks(T, S):
        R[:, a:b], L[:, a:b] = _stage_matrices_both(prob, m, dt, P[:, a:b],
                                                    Q[:, a:b], False)
    return R, L


def _forward_segment_scan(prob, m: int, dt, P_l, Q_l, P_r, Q_r, w_start,
                          schulz_X0=None, use_kernels: bool = True,
                          refine_iters=None, precond=None):
    """Propagate the scenario batch ``w_start (S, 2N, B)`` through one
    segment of ``L`` steps whose control tables are ``P_l, Q_l`` at the L
    left endpoints and ``P_r, Q_r`` at the L right endpoints, ``(S, L, m,
    N_ops)`` each (work dtype). Returns the in-segment history ``(S, L+1,
    2N, B)``, index 0 being ``w_start``.

    The segment's implicit-stage matrices are built at once (one
    LHS-kernel launch at batch S·L in f32), then their Newton-Schulz
    inverses (``solver="schulz"``, warm-started from ``schulz_X0``, the
    drift-only inverse) or LU factors (``"lu"``); each step then forms its
    explicit half (RHS kernel in f32) and solves. ``solver="gmres"`` builds
    no stage matrix: each step solves by GMRES with ``precond``."""
    if prob.solver == "gmres":
        # the segment's tables at its L+1 time points (P_l[:, k+1] is
        # P_r[:, k])
        P = torch.cat([P_l[:, :1], P_r], dim=1)
        Q = torch.cat([Q_l[:, :1], Q_r], dim=1)
        return torch.stack([w_start, *_step_states(
            prob, m, dt, P, Q, None, use_kernels, precond=precond,
            w_start=w_start)], dim=1)
    M = _stage_matrices(prob, m, dt, P_r, Q_r, -1.0, use_kernels)
    if prob.solver == "schulz":
        X = _hoisted_inverses(prob, m, dt, M, X0=schulz_X0)

        def solve(k, rhs):
            return inverse_stage_solve(M[:, k], X[:, k], rhs, refine_iters)
    else:
        lu, piv = factorize_stages(M)

        def solve(k, rhs):
            return solve_factored(lu[:, k], piv[:, k], rhs)

    w = w_start
    states = [w]
    for k in range(P_l.shape[1]):
        A_n = assemble_generator_stack(prob, P_l[:, k], Q_l[:, k], m)
        w = solve(k, _explicit_half(A_n, w, dt, m, use_kernels))
        states.append(w)
    return torch.stack(states, dim=1)


def _hermite_step(prob, m: int, dt, w, pq_n, pq_np1, schulz_X0=None,
                  use_kernels: bool = True, refine_iters=None, precond=None):
    """One Hermite step ``w_n -> w_{n+1}`` for the batch ``w (S, n, b)``
    with control tables ``pq_* = (P, Q)`` of shape ``(S, m, N_ops)``.
    Returns ``(w_next, lhs, rhs)``: the solve's result and the system it
    solved (the diagnostics measure its residual; ``lhs`` is ``None`` for
    the matrix-free GMRES solve)."""
    A_n = assemble_generator_stack(prob, pq_n[0], pq_n[1], m)
    A_np1 = assemble_generator_stack(prob, pq_np1[0], pq_np1[1], m)
    return _step_from_stacks(prob, m, dt, w, A_n, A_np1, schulz_X0,
                             use_kernels, refine_iters, precond=precond)


def _step_from_stacks(prob, m: int, dt, w, A_n, A_np1, schulz_X0,
                      use_kernels: bool, refine_iters,
                      forcing_n=None, forcing_np1=None, precond=None):
    """One step from the generator stacks at both ends, with the stage
    built and solved in the step (LHS kernel, then Schulz or LU), or
    solved by GMRES (``precond``: its preconditioner pair). The optional
    ``forcing_*`` ``(S, m, n, b)`` enter both halves; the forced explicit
    half is plain torch (the RHS kernel has no forcing term)."""
    gmres = prob.solver == "gmres"
    Ws = None
    if forcing_n is not None or gmres:   # GMRES starts from their Taylor sum
        Ws = scaled_derivatives(A_n, w, m, forcing=forcing_n)
    if forcing_n is None and (Ws is None or
                              _rhs_kernel_applies(w.dtype, use_kernels)):
        rhs = _explicit_half(A_n, w, dt, m, use_kernels)
    else:
        rhs = build_rhs(Ws, dt, m)
    if forcing_np1 is not None:
        # derivatives at t_{n+1} are affine in w_{n+1}: move the forced
        # zero-state part to the right-hand side
        G = scaled_derivatives(A_np1, torch.zeros_like(w), m,
                               forcing=forcing_np1)
        rhs = rhs - build_lhs(G, dt, m)
    if gmres:
        # the reference's Taylor initial guess
        w_next = hermite_gmres_stage(A_np1, rhs, taylor_expand(Ws, dt, m),
                                     dt, m, iters=prob.gmres_iters,
                                     precond=precond,
                                     use_kernels=use_kernels)
        return w_next, None, rhs
    lhs = _stage_from_stack(A_np1, m, dt, -1.0, use_kernels)
    if prob.solver == "schulz":
        X = schulz_inverse_auto(lhs, prob.schulz_iters, X0=schulz_X0,
                                warm_iters=_warm_budget(prob))
        return inverse_stage_solve(lhs, X, rhs, refine_iters), lhs, rhs
    return stage_solve(lhs, rhs), lhs, rhs


def _step_states(prob, m: int, dt, P, Q, schulz_X0, use_kernels: bool = True,
                 refine_iters=None, forcing=None, precond=None,
                 w_start=None):
    """Propagate ``w_start`` (default ``prob.w0``) through the ``T`` steps
    of the scenario batch of tables ``P, Q (S, T+1, m, N_ops)`` (work
    dtype), every stage built or solved inside the loop, and yield the
    states ``w_1 .. w_T`` ``(S, 2N, B)``. ``forcing``, if given, is ``(S,
    T+1, m, 2N, B)``. Each time point's generator stack is assembled once
    and serves as the implicit side of one step and the explicit side of
    the next. A
    generator, so that each caller stores the states as it needs: a
    preallocated trajectory, or a list stacked at the end where autograd
    records the loop (slice writes would copy the whole trajectory's
    gradient once per step on the way back)."""
    w = prob.w0.expand(P.shape[0], -1, -1) if w_start is None else w_start
    A_n = assemble_generator_stack(prob, P[:, 0], Q[:, 0], m)
    for k in range(P.shape[1] - 1):
        A_np1 = assemble_generator_stack(prob, P[:, k + 1], Q[:, k + 1], m)
        f_n = f_np1 = None
        if forcing is not None:
            f_n, f_np1 = forcing[:, k], forcing[:, k + 1]
        w, _, _ = _step_from_stacks(prob, m, dt, w, A_n, A_np1, schulz_X0,
                                    use_kernels, refine_iters, f_n, f_np1,
                                    precond)
        yield w
        A_n = A_np1


def _scenario_pcof(prob, pcof):
    """``(pcof (S, N_params) float64 on prob.device, single)``: a 1-D
    control vector becomes a batch of one. The autograd graph of a tensor
    that requires grad is kept."""
    pcof = torch.as_tensor(pcof, dtype=torch.float64).to(prob.device)
    single = pcof.dim() == 1
    return (pcof[None] if single else pcof), single


def _working_tables(prob, controls, pcof, m: int):
    """``(wprob, dt64, dt, P, Q)``: the working-dtype problem, the f64
    step, the step in the work dtype (a tensor on the device) and the
    control tables ``(S, T+1, m, N_ops)`` in the work dtype."""
    dt64, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    dt = torch.tensor(dt64, dtype=torch.float64, device=prob.device).to(wd)
    return working_problem(prob), dt64, dt, P.to(wd), Q.to(wd)


def hermite_forward_history(prob, controls, pcof, order: int = 2,
                            forcing=None, *, use_kernels: bool = True):
    """Propagate all initial conditions through ``prob.nsteps`` steps.

    Returns the state history ``(S, T+1, 2N, B)`` in the work dtype (index
    0 is the initial state; no scenario dimension for a 1-D ``pcof``).
    ``forcing``, if given, is ``(T+1, m, 2N, B)`` (shared by the scenarios)
    or ``(S, T+1, m, 2N, B)``, the scaled forcing derivatives
    ``f^{(j)}(t_n)/j!`` on the time grid. Differentiable by autograd when
    ``pcof`` requires grad.
    """
    controls = as_control_tuple(controls)
    m = order // 2
    pcof, single = _scenario_pcof(prob, pcof)
    wprob, dt64, dt, P, Q = _working_tables(prob, controls, pcof, m)
    w = wprob.w0.expand(P.shape[0], -1, -1)
    X0 = (_drift_stage_inverse(wprob, m, dt)
          if prob.solver == "schulz" else None)
    precond = _make_preconditioner(prob, dt64, order)
    if forcing is None and _use_precomputed_stages(wprob, m):
        # the whole horizon as one segment: every stage hoisted
        hist = _forward_segment_scan(wprob, m, dt, P[:, :-1], Q[:, :-1],
                                     P[:, 1:], Q[:, 1:], w, X0, use_kernels)
    else:
        if forcing is not None:
            forcing = torch.as_tensor(forcing).to(prob.device,
                                                  prob.work_dtype)
            forcing = forcing.expand((P.shape[0],)
                                     + tuple(forcing.shape[-4:]))
        hist = torch.stack([w, *_step_states(wprob, m, dt, P, Q, X0,
                                             use_kernels, forcing=forcing,
                                             precond=precond)], dim=1)
    return hist[0] if single else hist


def _thinned_forward_history(prob, controls, pcof, order: int,
                             save_every: int, use_kernels: bool = True,
                             refine_iters=None):
    """The states at every ``save_every``-th step, ``(S, nsteps/save_every
    + 1, 2N, B)`` in the work dtype for ``pcof (S, N_params)``, without
    holding the full history: segments of ``save_every`` steps
    (:func:`_forward_segment_scan`), of which only the last state is kept,
    so O(save_every) states are alive at a time."""
    m = order // 2
    wprob, dt64, dt, P, Q = _working_tables(prob, controls, pcof, m)
    X0 = (_drift_stage_inverse(wprob, m, dt)
          if prob.solver == "schulz" else None)
    precond = _make_preconditioner(prob, dt64, order)
    w = wprob.w0.expand(P.shape[0], -1, -1)
    saved = [w]
    for a in range(0, prob.nsteps, save_every):
        b = a + save_every
        w = _forward_segment_scan(wprob, m, dt, P[:, a:b], Q[:, a:b],
                                  P[:, a + 1:b + 1], Q[:, a + 1:b + 1], w,
                                  X0, use_kernels, refine_iters,
                                  precond)[:, -1]
        saved.append(w)
    return torch.stack(saved, dim=1)


def _derivatives_on_grid(prob, controls, pcof, ts, states, order: int,
                         forcing=None):
    """Scaled-derivative stacks ``(..., T', m+1, 2N, B)`` (float64) of the
    states ``(..., T', 2N, B)`` at the times ``ts (T',)``; ``forcing``, if
    given, ``(..., T', m, 2N, B)``."""
    m = order // 2
    P, Q = control_tables(controls, pcof, ts, m)
    A = assemble_generator_stack(prob, P, Q, m)
    return scaled_derivatives(A, states.to(torch.float64), m,
                              forcing=forcing)


def eval_forward(prob, controls, pcof, order: int = 2, *, save_every: int = 1,
                 forcing=None, return_derivatives: bool = False,
                 use_kernels: bool = True):
    """Forward evolution: the real-stacked state history ``(S, n_saved, 2N,
    B)`` (``(S, n_saved, m+1, 2N, B)`` with the scaled-derivative columns
    when ``return_derivatives``; no scenario dimension for a 1-D ``pcof``).

    ``save_every`` keeps every ``save_every``-th state (``nsteps`` must be
    divisible by it). Without ``forcing``, ``save_every > 1`` also thins
    memory: the full history is never held
    (:func:`_thinned_forward_history`).
    """
    controls = as_control_tuple(controls)
    if prob.nsteps % save_every != 0:
        raise ValueError("nsteps must be divisible by save_every")
    pcof_t, single = _scenario_pcof(prob, pcof)
    if save_every > 1 and forcing is None:
        saved = _thinned_forward_history(prob, controls, pcof_t, order,
                                         save_every, use_kernels)
    else:
        saved = hermite_forward_history(prob, controls, pcof_t, order,
                                        forcing=forcing,
                                        use_kernels=use_kernels)
        saved = saved[:, ::save_every]
    if not return_derivatives:
        return saved[0] if single else saved
    _, ts = _time_grid(prob)
    f_saved = None
    if forcing is not None:
        f_saved = torch.as_tensor(forcing).to(
            prob.device, torch.float64)[..., ::save_every, :, :, :]
    derivs = _derivatives_on_grid(prob, controls, pcof_t, ts[::save_every],
                                  saved, order, forcing=f_saved)
    return derivs[0] if single else derivs


def eval_forward_complex(prob, controls, pcof, order: int = 2, **kwargs):
    """Complex history ``(..., n_saved, N, B)``."""
    hist = eval_forward(prob, controls, pcof, order, **kwargs)
    N = prob.N_tot_levels
    return torch.complex(hist[..., :N, :], hist[..., N:, :])


def eval_adjoint(prob, controls, pcof, terminal_condition, order: int = 2,
                 forcing=None, *, use_kernels: bool = True):
    """Backward adjoint propagation: with the forward step
    ``LHS_{n+1} w_{n+1} = RHS_n w_n`` the multipliers satisfy::

        lambda_N = terminal_condition
        mu_n     = RHS_n^T lambda_{n+1} + forcing_n
        lambda_n = LHS_n^{-T} mu_n                 for n = N-1 .. 1

    ``terminal_condition`` is ``(S, 2N, B)`` (or ``(2N, B)`` for a 1-D
    ``pcof``), ``forcing`` the per-step adjoint source ``(S, T+1, 2N, B)``
    or ``(T+1, 2N, B)``. Returns ``(S, T+1, 2N, B)`` in the work dtype with
    index n holding lambda_n; index 0 is zero. The pairs ``(R_n, L_n)``
    come from the pair kernel in f32 (one launch over the hoisted time
    points, or one per step when the stages are not hoisted);
    ``use_kernels=False`` builds them in plain torch.
    """
    controls = as_control_tuple(controls)
    m = order // 2
    pcof, single = _scenario_pcof(prob, pcof)
    wprob, _, dt, P, Q = _working_tables(prob, controls, pcof, m)
    wd, n = prob.work_dtype, prob.nsteps
    lam = torch.as_tensor(terminal_condition).to(prob.device, wd)
    lam_N = lam[None] if single else lam
    if forcing is not None:
        forcing = torch.as_tensor(forcing).to(prob.device)
        if single:
            forcing = forcing[None]

    def f(k):
        if forcing is None:
            return 0.0
        return forcing[:, k].to(wd)

    lams = [lam_N]
    lam = lam_N
    if _use_precomputed_stages(wprob, m):
        # R and L at t_1..t_{N-1} (index k-1 holds time k)
        R, L = _hoisted_stage_pairs(wprob, m, dt, P[:, 1:n], Q[:, 1:n],
                                    use_kernels)
        LT = L.transpose(-1, -2)
        if prob.solver == "lu":
            lu, piv = factorize_stages(LT)

            def solve(k, mu):
                return solve_factored(lu[:, k], piv[:, k], mu)
        else:
            XT = _hoisted_inverses(wprob, m, dt, LT, transpose=True)

            def solve(k, mu):
                return inverse_stage_solve(LT[:, k], XT[:, k], mu)

        for k in range(n - 1, 0, -1):
            lam = solve(k - 1, R[:, k - 1].transpose(-1, -2) @ lam + f(k))
            lams.append(lam)
    else:
        X0T = (_drift_stage_inverse(wprob, m, dt, transpose=True)
               if prob.solver == "schulz" else None)
        for k in range(n - 1, 0, -1):
            R, L = _stage_matrices_both(wprob, m, dt, P[:, k], Q[:, k],
                                        use_kernels)
            mu = R.transpose(-1, -2) @ lam + f(k)
            if prob.solver == "schulz":
                LT = L.transpose(-1, -2)
                lam = inverse_stage_solve(
                    LT, schulz_inverse_auto(LT, prob.schulz_iters, X0=X0T,
                                            warm_iters=_warm_budget(wprob)),
                    mu)
            else:
                lam = stage_solve_transposed(L, mu)
            lams.append(lam)
    lams.append(torch.zeros_like(lam_N))
    hist = torch.stack(lams[::-1], dim=1)
    return hist[0] if single else hist
