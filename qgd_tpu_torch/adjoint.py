"""Gradient routes of the plain propagation (counterpart of
``qgd_tpu.adjoint``).

* :func:`objective_and_gradient` / ``discrete_adjoint(method=
  "lagrange")``: the Lagrange discrete adjoint. One forward history is
  shared by the objective and its gradient; then the guard forcing, the
  terminal-condition solve, the backward multiplier sweep
  (:func:`~qgd_tpu_torch.forward.eval_adjoint`) and the merged
  per-time-point cotangent

      cot_j(t_k) = dt^j c_j lambda_{k+1} - (-dt)^j c_j lambda_k

  passed, in chunks of time points, through the VJP of the
  scaled-derivative stack with respect to the control-table values; the
  pcof chain rule is one autograd pass through the whole-grid table
  build.
* ``discrete_adjoint(method="ad")``: autograd through the whole forward
  step loop, the independent cross-check.
* :func:`eval_grad_forced`: forward-mode AD of the objective, one tangent
  per parameter (the forced / GOAT gradient).
* :func:`eval_grad_finite_difference`: central differences.
* :func:`eval_hessian`: forward mode over the Lagrange gradient
  (``"ad"``), or the reference's four-point differences (``"fd"``).

The forward-mode routes carry one tangent per parameter as a scenario
batch of copies of ``pcof``, and the difference routes evaluate all their
perturbed vectors as one scenario batch. They run in either dtype: on an
f32 problem on the card the primal of each stage build comes from its
CUDA kernel and the tangent from the kernel ``autograd.Function``'s
forward-mode rule (``ops.stage_kernels``). The plain route they take
captures no CUDA graph, so every step runs eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch.overrides import TorchFunctionMode

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
    ic_sum,
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
from .segmented import _no_graph, _table_cot, segmented_gradient


def default_adjoint_method() -> str:
    """The gradient route ``discrete_adjoint(method="auto")`` takes: the
    hand-structured Lagrange adjoint (one forward history, one backward
    sweep). ``"ad"``, autograd through the step loop, keeps every step's
    intermediates and stays the independent cross-check."""
    return "lagrange"


def discrete_adjoint(prob, controls, pcof, target, order: int = 2,
                     cost_type: str = "Infidelity", method: str = "auto"):
    """Exact gradient of (terminal cost + guard penalty) with respect to
    ``pcof`` (the ridge gradient is the optimizer's). ``method``:
    ``"lagrange"`` (the default, ``"auto"``: :func:`default_adjoint_method`),
    ``"ad"`` (autograd through the forward step loop) or ``"segmented"``
    (the segmented route, its automatic segment count)."""
    controls = as_control_tuple(controls)
    if method == "auto":
        method = default_adjoint_method()
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
                           use_kernels: bool = True, ic_group=None):
    """Objective parts and the Lagrange gradient from one forward solve of
    the plain route. ``pcof`` is ``(S, N_params)`` or ``(N_params,)``.
    Returns ``((j1, guard, ridge), grad)`` in float64, each of ``j1``,
    ``guard``, ``ridge`` ``(S,)`` and ``grad (S, N_params)`` (scalars and
    ``(N_params,)`` for a 1-D ``pcof``), ridge term and its gradient
    included.

    ``ic_group``: a process group whose ranks each hold some gate columns
    of ``prob`` and ``target`` (``parallel.sharded``); the infidelity's
    traces, the guard and the gradient are summed over it, so every rank
    returns the objective and gradient of all the columns."""
    controls = as_control_tuple(controls)
    pcof, single = _scenario_pcof(prob, pcof)
    pcof = pcof.detach()
    history = eval_forward(prob, controls, pcof, order,
                           use_kernels=use_kernels)
    j1, _ = terminal_cost_and_grad(history[:, -1].to(torch.float64),
                                   target_on_device(prob, target),
                                   prob.N_ess_levels, cost_type, ic_group)
    guard = ic_sum(guard_penalty_real(history, prob.tf / prob.nsteps,
                                      prob.tf, prob.guard_subspace_projector),
                   ic_group)
    ridge = ridge_penalty(pcof, ridge_penalty_strength)
    grad = _discrete_adjoint_lagrange(prob, controls, pcof, target, order,
                                      cost_type, history=history,
                                      ic_group=ic_group,
                                      use_kernels=use_kernels)
    grad = grad + 2.0 * ridge_penalty_strength * pcof / pcof.shape[-1]
    if single:
        return (j1[0], guard[0], ridge[0]), grad[0]
    return (j1, guard, ridge), grad


def _discrete_adjoint_lagrange(prob, controls, pcof, target, order: int,
                               cost_type: str, history=None, ic_group=None,
                               use_kernels: bool = True):
    """Hand-structured discrete adjoint for ``pcof (S, N_params)`` (see the
    module docstring); ``history`` is reused from the objective's forward
    solve when given; ``ic_group`` and ``use_kernels`` as in
    :func:`objective_and_gradient`. Returns ``(S, N_params)`` float64."""
    m = order // 2
    dt, ts = _time_grid(prob)
    if history is None:
        history = eval_forward(prob, controls, pcof, order,
                               use_kernels=use_kernels)

    forcing = compute_guard_forcing(prob, history)
    _, g_T = terminal_cost_and_grad(history[:, -1].to(torch.float64),
                                    target_on_device(prob, target),
                                    prob.N_ess_levels, cost_type, ic_group)
    lam_N = _solve_lhsT_at_tf(prob, controls, pcof, g_T + forcing[:, -1],
                              order)
    lam = eval_adjoint(prob, controls, pcof, lam_N, order, forcing=forcing,
                       use_kernels=use_kernels)
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
    Pw, Qw = _no_graph(P64).to(wd), _no_graph(Q64).to(wd)
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
    return ic_sum(grad, ic_group)


def _batched(prob, S: int):
    """``prob`` with its hoisting estimate sized for ``S`` scenarios."""
    if int(prob.hoist_batch_hint) < S:
        return dataclasses.replace(prob, hoist_batch_hint=S)
    return prob


class _ZeroTangents(TorchFunctionMode):
    """Gives every plain floating operand of an arithmetic op a zero
    forward-mode tangent when another operand carries one. PyTorch forms
    the missing tangent of a plain operand as a lazily-zero tensor on a
    slow path (≈ 0.4 ms per op on the CPU and on the card, about 30× the op
    itself), so the step loops of the forward-mode checks spent most of
    their time there. A materialized zero tangent gives the same
    arithmetic, bit for bit."""

    # what the operators reach (``a * 2`` and ``2 * a`` are Tensor.mul,
    # ``a += b`` is Tensor.add_, ``2 / a`` is Tensor.__rdiv__)
    _ARITH = {torch.Tensor.mul, torch.Tensor.div, torch.Tensor.__rdiv__,
              torch.Tensor.add, torch.Tensor.sub, torch.Tensor.__rsub__,
              torch.Tensor.matmul, torch.Tensor.add_, torch.mul, torch.div,
              torch.add, torch.sub, torch.matmul, torch.einsum}
    # the first operand of these is updated in place: it keeps its own
    _INPLACE = {torch.Tensor.add_}

    @staticmethod
    def _zero_tangent(x, like):
        if isinstance(x, (float, int)) and not isinstance(x, bool):
            x = torch.tensor(x, dtype=like.dtype, device=like.device)
        if (not isinstance(x, torch.Tensor) or not x.is_floating_point()
                or fwAD.unpack_dual(x).tangent is not None):
            return x
        if 0 in x.stride():
            x = x.contiguous()      # a tangent cannot take a broadcast layout
        return fwAD.make_dual(x, torch.zeros_like(x))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self._ARITH:
            like = next((a for a in args if isinstance(a, torch.Tensor)
                         and fwAD.unpack_dual(a).tangent is not None), None)
            if like is not None:
                # einsum's first argument is its equation
                keep = 1 if (func in self._INPLACE
                             or func is torch.einsum) else 0
                args = args[:keep] + tuple(self._zero_tangent(a, like)
                                           for a in args[keep:])
        return func(*args, **(kwargs or {}))


def _one_tangent_per_parameter(prob, pcof, fn):
    """Run ``fn(prob, pcof_batch)`` in forward mode on the batch of ``n``
    copies of the 1-D ``pcof``, copy ``i`` carrying the tangent ``e_i``;
    returns the tangent of the result (``(n,)`` for a value, ``(n, n)``
    with row i the derivative along ``e_i`` for a gradient)."""
    pc = torch.as_tensor(pcof, dtype=torch.float64).to(prob.device).detach()
    if pc.dim() != 1:
        raise ValueError(f"pcof must be 1-D, got shape {tuple(pc.shape)}")
    n = pc.shape[0]
    eye = torch.eye(n, dtype=torch.float64, device=prob.device)
    with fwAD.dual_level(), _ZeroTangents():
        dual = fwAD.make_dual(pc.expand(n, n).contiguous(), eye)
        out = fn(_batched(prob, n), dual)
        return fwAD.unpack_dual(out).tangent


def eval_grad_forced(prob, controls, pcof, target, order: int = 2,
                     cost_type: str = "Infidelity"):
    """Forced / GOAT gradient ``(N_params,)`` of (terminal cost + guard
    penalty) at the 1-D ``pcof``: forward-mode AD of the discrete scheme
    with one tangent per parameter, whose tangent states obey the forced
    variational equation with forcing ``(dA/dtheta_k) w``."""
    controls = as_control_tuple(controls)
    return _one_tangent_per_parameter(
        prob, pcof, lambda p, pc: objective_value(p, controls, pc, target,
                                                  order, cost_type=cost_type))


def _perturbed_values(prob, controls, target, order, cost_type, batch):
    """Objective (ridge 0) at each row of the numpy ``batch``, as one
    scenario batch, in float64 numpy."""
    vals = objective_value(_batched(prob, batch.shape[0]), controls,
                           torch.as_tensor(batch), target, order,
                           cost_type=cost_type)
    return vals.detach().cpu().numpy()


def eval_grad_finite_difference(prob, controls, pcof, target, order: int = 2,
                                dpcof: float = 1e-5,
                                cost_type: str = "Infidelity"):
    """Central-difference gradient ``(f(p + d e_i) - f(p - d e_i)) / 2d``
    at the 1-D ``pcof``, ``d = dpcof``, float64 ``(N_params,)`` on
    ``prob.device``. The perturbed vectors are formed as the JAX package
    forms them (``+= d``, then ``-= 2d``) and evaluated in one batch."""
    controls = as_control_tuple(controls)
    pc = np.asarray(torch.as_tensor(pcof).detach().cpu(), dtype=np.float64)
    n = pc.size
    batch = np.repeat(pc[None], 2 * n, axis=0)
    for i in range(n):
        batch[i, i] += dpcof
        batch[n + i, i] = batch[i, i] - 2 * dpcof
    vals = _perturbed_values(prob, controls, target, order, cost_type, batch)
    grad = (vals[:n] - vals[n:]) / (2 * dpcof)
    return torch.as_tensor(grad, device=prob.device)


def eval_hessian(prob, controls, pcof, target, order: int = 2,
                 cost_type: str = "Infidelity", method: str = "ad"):
    """Hessian ``(N_params, N_params)`` of (terminal cost + guard penalty)
    at the 1-D ``pcof``, float64 on ``prob.device``. ``"ad"``: exact,
    forward mode over the Lagrange gradient; ``"fd"``: the reference's
    four-point central differences with step 1e-4, the perturbed vectors
    formed as the JAX package forms them and evaluated in one batch."""
    controls = as_control_tuple(controls)
    if method == "ad":
        H = _one_tangent_per_parameter(
            prob, pcof, lambda p, pc: _discrete_adjoint_lagrange(
                p, controls, pc, target, order, cost_type))
        return H.T.contiguous()
    if method != "fd":
        raise ValueError(f"unknown method {method!r}")
    eps = 1e-4
    pc = np.asarray(torch.as_tensor(pcof).detach().cpu(), dtype=np.float64)
    n = pc.size
    pairs = [(i, j) for i in range(n) for j in range(i, n)]
    batch = np.empty((4 * len(pairs), n))
    for k, (i, j) in enumerate(pairs):
        pij = pc.copy()
        pij[i] += eps
        pij[j] += eps
        batch[4 * k] = pij              # f(++)
        pij[j] -= 2 * eps
        batch[4 * k + 1] = pij          # f(+-)
        pij[i] -= 2 * eps
        batch[4 * k + 2] = pij          # f(--)
        pij[j] += 2 * eps
        batch[4 * k + 3] = pij          # f(-+)
    f = _perturbed_values(prob, controls, target, order, cost_type, batch)
    H = np.zeros((n, n))
    for k, (i, j) in enumerate(pairs):
        fpp, fpm, fmm, fmp = f[4 * k:4 * k + 4]
        H[i, j] = H[j, i] = (fpp - fpm - fmp + fmm) / (4 * eps * eps)
    return torch.as_tensor(H, device=prob.device)
