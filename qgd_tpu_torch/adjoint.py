"""The Lagrange discrete-adjoint gradient of the plain route (counterpart
of ``qgd_tpu.adjoint``): one forward history shared by the objective and
its gradient, the guard forcing, the terminal-condition solve, the
backward multiplier sweep (:func:`~qgd_tpu_torch.forward.eval_adjoint`)
and the merged per-time-point cotangent

    cot_j(t_k) = dt^j c_j lambda_{k+1} - (-dt)^j c_j lambda_k

passed, in chunks of time points, through the VJP of the scaled-derivative
stack with respect to the control-table values; the pcof chain rule is one
autograd pass through the whole-grid table build.

``discrete_adjoint(method="ad")`` is the independent cross-check: autograd
through the whole forward step loop.
"""

from __future__ import annotations

import torch

from .controls import as_control_tuple, control_tables, control_tables_at
from .forward import (
    _chunks,
    _scenario_pcof,
    _time_grid,
    eval_adjoint,
    eval_forward,
)
from .objective import (
    guard_penalty_real,
    objective_value,
    ridge_penalty,
    target_on_device,
    terminal_cost_and_grad,
)
from .ops.hermite import (
    assemble_generator_stack,
    build_lhs,
    hermite_coefficients,
    scaled_derivatives,
)
from .ops.linalg import (
    inverse_stage_solve,
    schulz_inverse_auto,
    stage_solve_transposed,
)
from .problem import working_problem
from .segmented import _table_cot, segmented_gradient


def discrete_adjoint(prob, controls, pcof, target, order: int = 2,
                     cost_type: str = "Infidelity", method: str = "auto"):
    """Exact gradient of (terminal cost + guard penalty) with respect to
    ``pcof`` (the ridge gradient is the optimizer's). ``method``:
    ``"lagrange"`` (the default, ``"auto"``), ``"ad"`` (autograd through
    the forward step loop) or ``"segmented"`` (the segment-length-1
    route, ``solver="schulz"``)."""
    controls = as_control_tuple(controls)
    if method == "auto":
        method = "lagrange"
    if method == "ad":
        pc, single = _scenario_pcof(prob, pcof)
        pc = pc.detach().requires_grad_(True)
        with torch.enable_grad():
            val = objective_value(prob, controls, pc, target, order,
                                  cost_type=cost_type)
            (grad,) = torch.autograd.grad(val.sum(), pc)
        return grad[0] if single else grad
    if method == "lagrange":
        pc, single = _scenario_pcof(prob, pcof)
        grad = _discrete_adjoint_lagrange(prob, controls, pc.detach(), target,
                                          order, cost_type)
        return grad[0] if single else grad
    if method == "segmented":
        return segmented_gradient(prob, controls, pcof, target, order,
                                  cost_type=cost_type)
    raise ValueError(f"unknown method {method!r}")


def compute_guard_forcing(prob, history):
    """Adjoint source of the guard penalty, ``dJ_guard/dw_n = (2 dt/T)
    tau_n W w_n`` with trapezoid weights ``tau``, for ``history (..., T+1,
    2N, B)`` -> the same shape in float64."""
    dt = prob.tf / prob.nsteps
    W = prob.guard_subspace_projector
    f = (W @ history.to(torch.float64)) * (2.0 * dt / prob.tf)
    weights = torch.ones(f.shape[-3], dtype=f.dtype, device=f.device)
    weights[0] = weights[-1] = 0.5
    return f * weights[:, None, None]


def compute_terminal_condition(prob, controls, pcof, target, final_state,
                               order: int = 2, cost_type: str = "Infidelity",
                               forcing=None):
    """Solve ``LHS(t_f)^T lambda_N = dJ/dw_N (+ forcing)`` for
    ``final_state (S, 2N, B)`` (or ``(2N, B)`` with a 1-D ``pcof``);
    lambda is the gradient-of-cost multiplier."""
    controls = as_control_tuple(controls)
    _, g = terminal_cost_and_grad(
        torch.as_tensor(final_state).to(prob.device, torch.float64),
        target_on_device(prob, target), prob.N_ess_levels, cost_type)
    if forcing is not None:
        g = g + forcing
    pc, single = _scenario_pcof(prob, pcof)
    lam = _solve_lhsT_at_tf(prob, controls, pc, g if not single else g[None],
                            order)
    return lam[0] if single else lam


def _solve_lhsT_at_tf(prob, controls, pcof, g, order: int):
    """Solve the transposed float64 one-step LHS at ``t_f`` against ``g
    (S, 2N, B)`` (Newton-Schulz inverse plus 4 refinement sweeps, or LU)."""
    m = order // 2
    dt = prob.tf / prob.nsteps
    p, q = control_tables_at(controls, pcof, prob.tf, m)
    A = assemble_generator_stack(prob, p, q, m)
    eye = torch.eye(prob.real_system_size, dtype=torch.float64,
                    device=prob.device)
    lhs = build_lhs(scaled_derivatives(A, eye, m), dt, m)
    if prob.solver == "schulz":
        MT = lhs.transpose(-1, -2)
        return inverse_stage_solve(MT, schulz_inverse_auto(
            MT, prob.schulz_iters), g)
    return stage_solve_transposed(lhs, g)


def objective_and_gradient(prob, controls, pcof, target, order: int = 4,
                           cost_type: str = "Infidelity",
                           ridge_penalty_strength: float = 0.0, *,
                           use_kernels: bool = True):
    """Objective parts and the Lagrange gradient from one forward solve of
    the plain route. ``pcof`` is ``(S, N_params)`` or ``(N_params,)``.
    Returns ``((j1, guard, ridge), grad)`` in float64, each of ``j1``,
    ``guard``, ``ridge`` ``(S,)`` and ``grad (S, N_params)`` (scalars and
    ``(N_params,)`` for a 1-D ``pcof``), ridge term and its gradient
    included."""
    controls = as_control_tuple(controls)
    pcof, single = _scenario_pcof(prob, pcof)
    pcof = pcof.detach()
    history = eval_forward(prob, controls, pcof, order,
                           use_kernels=use_kernels)
    j1, _ = terminal_cost_and_grad(history[:, -1].to(torch.float64),
                                   target_on_device(prob, target),
                                   prob.N_ess_levels, cost_type)
    guard = guard_penalty_real(history, prob.tf / prob.nsteps, prob.tf,
                               prob.guard_subspace_projector)
    ridge = ridge_penalty(pcof, ridge_penalty_strength)
    grad = _discrete_adjoint_lagrange(prob, controls, pcof, target, order,
                                      cost_type, history=history)
    grad = grad + 2.0 * ridge_penalty_strength * pcof / pcof.shape[-1]
    if single:
        return (j1[0], guard[0], ridge[0]), grad[0]
    return (j1, guard, ridge), grad


def _discrete_adjoint_lagrange(prob, controls, pcof, target, order: int,
                               cost_type: str, history=None):
    """Hand-structured discrete adjoint for ``pcof (S, N_params)`` (see the
    module docstring); ``history`` is reused from the objective's forward
    solve when given. Returns ``(S, N_params)`` float64."""
    m = order // 2
    dt, ts = _time_grid(prob)
    if history is None:
        history = eval_forward(prob, controls, pcof, order)

    forcing = compute_guard_forcing(prob, history)
    _, g_T = terminal_cost_and_grad(history[:, -1].to(torch.float64),
                                    target_on_device(prob, target),
                                    prob.N_ess_levels, cost_type)
    lam_N = _solve_lhsT_at_tf(prob, controls, pcof, g_T + forcing[:, -1],
                              order)
    lam = eval_adjoint(prob, controls, pcof, lam_N, order, forcing=forcing)
    del forcing

    c = torch.tensor(hermite_coefficients(m), dtype=torch.float64,
                     device=prob.device)
    jpow = torch.arange(m + 1, dtype=torch.float64, device=prob.device)
    w_rhs = (c * dt ** jpow)[:, None, None]          # dt^j c_j
    w_lhs = (c * (-dt) ** jpow)[:, None, None]       # (-dt)^j c_j

    wd = prob.work_dtype
    wprob = working_problem(prob)
    with torch.enable_grad():
        pcof_leaf = pcof.clone().requires_grad_(True)
        P64, Q64 = control_tables(controls, pcof_leaf, ts, m)
    Pw, Qw = P64.detach().to(wd), Q64.detach().to(wd)
    S, T1 = Pw.shape[:2]
    cotP, cotQ = torch.empty_like(Pw), torch.empty_like(Qw)
    for a, b in _chunks(T1, S):
        # lambda_{k+1}, zero past the end
        lam_next = lam[:, a + 1:b + 1]
        if b == T1:
            lam_next = torch.cat([lam_next, torch.zeros_like(lam[:, :1])],
                                 dim=1)
        cot = (w_rhs * lam_next[:, :, None].to(torch.float64)
               - w_lhs * lam[:, a:b, None].to(torch.float64))
        cotP[:, a:b], cotQ[:, a:b] = _table_cot(
            wprob, m, Pw[:, a:b], Qw[:, a:b], history[:, a:b], cot.to(wd))
    (grad,) = torch.autograd.grad(
        (P64, Q64), pcof_leaf,
        (cotP.to(torch.float64), cotQ.to(torch.float64)))
    return grad
