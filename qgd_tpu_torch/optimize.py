"""Optimizer drivers (counterpart of ``qgd_tpu.optimize``).

* :func:`optimize_gate`: scipy L-BFGS-B on the host minimizing
  ``infidelity + guard penalty + ridge`` over one control vector; each
  evaluation is one objective + gradient call on ``prob.device`` and one
  copy of its float64 result to the host.
* :func:`optimize_gate_multistart`: L-BFGS with a backtracking (Armijo)
  line search over a batch of starts ``(S, N_params)``, in torch on
  ``prob.device``: the arithmetic of optax's ``lbfgs`` with
  ``scale_by_backtracking_linesearch(store_grad=False)`` (what the JAX
  package vmaps over starts), batched, with a per-start mask for the line
  search and for converged starts.
* :func:`gradient_descent`: fixed-step descent.

Per-iteration records go into :class:`OptimizationHistory`, whose JSON +
npz checkpoint files are the JAX package's, so a history written by
either package loads in the other.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from .controls import as_control_tuple

# Entries of ROADMAP.md "What is left" that the unported options name.
_LBFGS_ITEM = "ROADMAP.md 'What is left', item 2 (method='lbfgs')"
_PREFIX_ITEM = "ROADMAP.md 'What is left', item 5 (prefix.py)"


@dataclass
class OptimizationHistory:
    """Per-iteration record of an optimization run."""
    iter_count: list = dfield(default_factory=list)
    obj_value: list = dfield(default_factory=list)
    wall_time: list = dfield(default_factory=list)
    pcof: list = dfield(default_factory=list)
    grad_pcof: list = dfield(default_factory=list)
    analytic_obj_value: list = dfield(default_factory=list)
    infidelity: list = dfield(default_factory=list)
    guard_penalty: list = dfield(default_factory=list)
    ridge_penalty: list = dfield(default_factory=list)

    def append(self, it, obj, wall, pcof, grad, infid, guard, ridge):
        self.iter_count.append(int(it))
        self.obj_value.append(float(obj))
        self.wall_time.append(float(wall))
        self.pcof.append(np.asarray(pcof).copy())
        self.grad_pcof.append(np.asarray(grad).copy())
        self.analytic_obj_value.append(float(infid) + float(guard)
                                       + float(ridge))
        self.infidelity.append(float(infid))
        self.guard_penalty.append(float(guard))
        self.ridge_penalty.append(float(ridge))

    @property
    def best_index(self) -> int:
        return int(np.argmin(self.obj_value))

    @property
    def best_pcof(self):
        return self.pcof[self.best_index]

    def summary(self) -> str:
        if not self.obj_value:
            return "OptimizationHistory (empty)"
        i_obj = self.best_index
        i_inf = int(np.argmin(self.infidelity))
        return (
            f"OptimizationHistory: {len(self.obj_value)} iterations\n"
            f"  min objective  {self.obj_value[i_obj]:.6e} at iter "
            f"{self.iter_count[i_obj]}\n"
            f"  min infidelity {self.infidelity[i_inf]:.6e} at iter "
            f"{self.iter_count[i_inf]}")

    def save(self, filename: str):
        """Write ``<filename>.json`` (scalars) and ``<filename>.npz``
        (``pcof``, ``grad_pcof``)."""
        meta = {k: getattr(self, k) for k in (
            "iter_count", "obj_value", "wall_time", "analytic_obj_value",
            "infidelity", "guard_penalty", "ridge_penalty")}
        with open(filename + ".json", "w") as f:
            json.dump(meta, f)
        np.savez_compressed(filename + ".npz",
                            pcof=np.asarray(self.pcof),
                            grad_pcof=np.asarray(self.grad_pcof))

    @staticmethod
    def load(filename: str) -> "OptimizationHistory":
        with open(filename + ".json") as f:
            meta = json.load(f)
        with np.load(filename + ".npz") as arrs:
            h = OptimizationHistory(**meta)
            h.pcof = list(arrs["pcof"])
            h.grad_pcof = list(arrs["grad_pcof"])
        return h


class _StopOptimization(Exception):
    pass


def _check_unported(method: str, gradient_route: str,
                    max_dispatch_steps: int):
    if method == "lbfgs":
        raise NotImplementedError(
            f"method='lbfgs' (L-BFGS on the device with box bounds) is not "
            f"ported: {_LBFGS_ITEM}; use method='lbfgsb'")
    if method != "lbfgsb":
        raise ValueError(f"unknown method {method!r}")
    if gradient_route == "prefix":
        raise NotImplementedError(
            f"gradient_route='prefix' is not ported: {_PREFIX_ITEM}")
    if gradient_route != "auto":
        raise ValueError(f"unknown gradient_route {gradient_route!r}")
    if max_dispatch_steps > 0:
        raise NotImplementedError(
            "max_dispatch_steps > 0 selects the host-chunked driver "
            "(qgd_tpu/chunked.py), which exists for a TPU dispatch "
            "watchdog and is not ported (ROADMAP.md 'Not to port'); the "
            "segmented route bounds memory on the card")


def optimize_gate(prob, controls, pcof_init, target, *, order: int = 4,
                  pcof_L=None, pcof_U=None, maxIter: int = 50,
                  max_cpu_time: float = 300.0,
                  ridge_penalty_strength: float = 1e-2,
                  stop_objective: float = 1e-7,
                  tol: float = 1e-5,
                  lbfgs_history: int = 40,
                  method: str = "lbfgsb",
                  filename: str | None = None,
                  print_level: int = 5,
                  cost_type: str = "Infidelity",
                  n_segments: int | None = None,
                  max_dispatch_steps: int = 0,
                  gradient_route: str = "auto",
                  resume_from: str | None = None) -> OptimizationHistory:
    """Optimize one control vector with scipy L-BFGS-B.

    ``pcof_L``/``pcof_U``: box bounds, scalar or per-parameter vector.
    ``resume_from``: a history checkpoint basename; restarts from its last
    pcof and appends to the loaded history. ``filename``: the setup
    (:func:`~qgd_tpu_torch.checkpoint.save_setup`) is written once and the
    history after every evaluation. ``n_segments``: ``None`` picks the
    plain route below 16384 steps and the segmented route (L = 1) above,
    ``0`` forces the plain route, ``nsteps`` the segmented one. The loop
    stops once the objective drops below ``stop_objective`` or the wall
    time passes ``max_cpu_time``. Returns the :class:`OptimizationHistory`.
    """
    from .adjoint import objective_and_gradient
    from .segmented import segmented_objective_and_gradient

    _check_unported(method, gradient_route, max_dispatch_steps)
    controls = as_control_tuple(controls)
    resumed = None
    if resume_from is not None:
        resumed = OptimizationHistory.load(resume_from)
        pcof_init = resumed.pcof[-1]
    if isinstance(pcof_init, torch.Tensor):
        pcof_init = pcof_init.detach().cpu().numpy()
    pcof0 = np.asarray(pcof_init, dtype=np.float64)
    n = pcof0.size

    def _bounds_vec(b, default):
        if b is None:
            return np.full(n, default)
        b = np.asarray(b, dtype=np.float64)
        return np.full(n, float(b)) if b.ndim == 0 else b

    lower = _bounds_vec(pcof_L, -np.inf)
    upper = _bounds_vec(pcof_U, np.inf)

    if filename is not None and resume_from is None:
        # the whole setup once, so that resume_optimization needs only the
        # filename (routing options included)
        from .checkpoint import save_setup

        save_setup(filename, prob, controls, target, order=order,
                   pcof_L=pcof_L, pcof_U=pcof_U,
                   ridge_penalty_strength=ridge_penalty_strength,
                   cost_type=cost_type, maxIter=maxIter,
                   max_cpu_time=max_cpu_time, stop_objective=stop_objective,
                   tol=tol, lbfgs_history=lbfgs_history, method=method,
                   print_level=print_level, gradient_route=gradient_route,
                   n_segments=n_segments,
                   max_dispatch_steps=max_dispatch_steps)

    if n_segments is None:
        # past ~16k steps the plain route's O(T) hoisted tensors dominate
        n_segments = 0 if prob.nsteps < 16384 else -1

    def value_parts_and_grad(pc):
        pct = torch.as_tensor(pc, dtype=torch.float64, device=prob.device)
        if n_segments == 0:
            (j1, guard, ridge), grad = objective_and_gradient(
                prob, controls, pct, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength)
        else:
            (j1, guard, ridge), grad = segmented_objective_and_gradient(
                prob, controls, pct, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength,
                n_segments=max(n_segments, 0))
        # one copy to the host per evaluation
        host = torch.cat([torch.stack([j1, guard, ridge]), grad]).cpu().numpy()
        j1, guard, ridge = host[:3]
        return j1 + guard + ridge, (j1, guard, ridge), host[3:]

    history = resumed if resumed is not None else OptimizationHistory()
    t_start = time.perf_counter()
    state = dict(it=history.iter_count[-1] + 1 if history.iter_count else 0)

    def eval_and_record(pc):
        val, (j1, guard, ridge), grad = value_parts_and_grad(pc)
        val = float(val)
        wall = time.perf_counter() - t_start
        history.append(state["it"], val, wall, pc, grad, j1, guard, ridge)
        state["it"] += 1
        if print_level >= 5:
            print(f"iter {state['it']:4d}  obj {val:.6e}  infid {float(j1):.6e} "
                  f"guard {float(guard):.3e}  |g| {np.linalg.norm(grad):.3e}")
        if not (0.0 <= float(j1) <= 1.0) and cost_type == "Infidelity":
            print("Warning: infidelity outside [0, 1] "
                  "(loss of accuracy or optimizer out of bounds)")
        if filename is not None:
            history.save(filename)
        if val < stop_objective or wall > max_cpu_time:
            raise _StopOptimization
        return val, grad

    from scipy.optimize import minimize

    try:
        minimize(eval_and_record, pcof0, jac=True, method="L-BFGS-B",
                 bounds=list(zip(lower, upper)),
                 options=dict(maxiter=maxIter, maxcor=lbfgs_history,
                              ftol=1e-18, gtol=tol))
    except _StopOptimization:
        pass

    if print_level >= 3:
        print(history.summary())
    return history


class _BatchedLBFGS:
    """optax ``lbfgs(memory_size, linesearch=scale_by_backtracking_
    linesearch(...))`` over a batch of starts ``(S, n)``: the
    ``scale_by_lbfgs`` memory and direction (``optax/_src/transform.py``),
    ``scale(-1)``, then the backtracking search (``optax/_src/
    linesearch.py``) with its own step size per start."""

    def __init__(self, pcofs, memory_size: int, max_steps: int,
                 decrease_factor: float, increase_factor: float,
                 slope_rtol: float = 1e-4, max_learning_rate: float = 1.0):
        S, n = pcofs.shape
        z = dict(dtype=pcofs.dtype, device=pcofs.device)
        self.M = memory_size
        self.count = 0
        self.params = torch.zeros((S, n), **z)
        self.updates = torch.zeros((S, n), **z)
        self.dw = torch.zeros((S, memory_size, n), **z)
        self.du = torch.zeros((S, memory_size, n), **z)
        self.rho = torch.zeros((S, memory_size), **z)
        self.learning_rate = torch.ones(S, **z)
        self.max_steps = max_steps
        self.decrease = decrease_factor
        self.increase = increase_factor
        self.slope_rtol = slope_rtol
        self.max_lr = max_learning_rate

    def direction(self, params, grad):
        """``scale_by_lbfgs`` then ``scale(-1)``: update the memory with
        the new pair and return ``-P_k grad``."""
        M, k = self.M, self.count
        if k > 0:
            dparams = params - self.params
            dupd = grad - self.updates
            vdot = torch.sum(dupd * dparams, dim=-1)
            weight = torch.where(vdot == 0.0, torch.zeros_like(vdot),
                                 1.0 / vdot)
            den = torch.sum(dupd * dupd, dim=-1)
            gamma = torch.where(den > 0.0, vdot / den, torch.ones_like(den))
        else:
            dparams, dupd = torch.zeros_like(params), torch.zeros_like(grad)
            weight = torch.zeros_like(grad[:, 0])
            gamma = torch.clamp(1.0 / torch.sqrt(torch.sum(grad * grad, -1)),
                                max=1.0)
        prev = (k - 1) % M
        self.dw[:, prev], self.du[:, prev], self.rho[:, prev] = \
            dparams, dupd, weight
        # two-loop recursion over the filled slots, newest first; the empty
        # slots (zero pairs, zero weights) leave the vector unchanged
        order = [(k + i) % M for i in range(M)][M - min(k, M):]
        vec, alphas = grad, {}
        for idx in reversed(order):
            alphas[idx] = self.rho[:, idx] * torch.sum(self.dw[:, idx] * vec,
                                                       dim=-1)
            vec = vec + (-alphas[idx])[:, None] * self.du[:, idx]
        vec = gamma[:, None] * vec
        for idx in order:
            beta = self.rho[:, idx] * torch.sum(self.du[:, idx] * vec, dim=-1)
            vec = vec + (alphas[idx] - beta)[:, None] * self.dw[:, idx]
        self.count = k + 1
        self.params, self.updates = params, grad
        return -1.0 * vec

    def step_size(self, params, updates, value, grad, value_fn):
        """Backtracking until ``f(w + eta u) <= f(w) + eta c <u, grad f>``
        per start, at most ``max_steps + 1`` probes; ``value_fn`` is called
        on the starts still searching."""
        slope = torch.sum(updates * grad, dim=-1)
        lr = torch.clamp(self.increase * self.learning_rate, max=self.max_lr)
        err = torch.full_like(value, float("inf"))
        it = torch.zeros(value.shape, dtype=torch.int64, device=value.device)
        while True:
            active = ~(err <= 0.0) & (it <= self.max_steps)
            idx = torch.nonzero(active).flatten()
            if idx.numel() == 0:
                break
            lr_a = torch.where(it[idx] > 0, self.decrease * lr[idx], lr[idx])
            new_value = value_fn(params[idx] + lr_a[:, None] * updates[idx])
            e = new_value - value[idx] - lr_a * self.slope_rtol * slope[idx]
            e = torch.where(torch.isnan(e), torch.full_like(e, float("inf")),
                            e)
            lr[idx], err[idx] = lr_a, torch.clamp(e, min=0.0)
            it[idx] += 1
        self.learning_rate = torch.where(torch.isinf(err),
                                         torch.zeros_like(lr), lr)
        return self.learning_rate


def optimize_gate_multistart(prob, controls, pcofs_init, target, *,
                             order: int = 4, pcof_L=None, pcof_U=None,
                             maxIter: int = 50,
                             ridge_penalty_strength: float = 1e-2,
                             stop_objective: float = 1e-7,
                             lbfgs_history: int = 40,
                             print_level: int = 5,
                             cost_type: str = "Infidelity",
                             ls_max_steps: int = 25,
                             ls_decrease_factor: float = 0.5,
                             ls_increase_factor: float = 1.5,
                             gradient_route: str = "plain",
                             n_segments: int = 0):
    """Batched multi-start optimization: L-BFGS over a batch of initial
    control vectors ``pcofs_init (S, n)``, every start advancing in
    lockstep on ``prob.device``, one objective + gradient call for all S
    starts per iteration and value-only calls for the line-search probes
    of the starts still searching. Starts that reach ``stop_objective``
    are frozen. ``gradient_route``: ``"plain"`` (the Lagrange route) or
    ``"segmented"`` (the segment-length-1 route, ``solver="schulz"``).
    ``prob.hoist_batch_hint`` is raised to S.

    Returns ``(pcofs (S, n), objs (iterations, S))``: the final parameters
    (on ``prob.device``) and the objective at the start of each iteration
    (numpy).
    """
    import dataclasses

    from .adjoint import objective_and_gradient
    from .objective import objective_value
    from .segmented import (segmented_objective_and_gradient,
                            segmented_objective_value)

    controls = as_control_tuple(controls)
    pcofs = torch.as_tensor(pcofs_init, dtype=torch.float64).to(prob.device)
    S = pcofs.shape[0]
    bound = lambda b, inf: torch.as_tensor(
        inf if b is None else b, dtype=torch.float64).to(prob.device)
    lo, hi = bound(pcof_L, -float("inf")), bound(pcof_U, float("inf"))
    if int(prob.hoist_batch_hint) < S:
        prob = dataclasses.replace(prob, hoist_batch_hint=S)

    kw = dict(cost_type=cost_type,
              ridge_penalty_strength=ridge_penalty_strength)
    if gradient_route == "segmented":
        oag = lambda pc: segmented_objective_and_gradient(
            prob, controls, pc, target, order, n_segments=n_segments, **kw)
        value_fn = lambda pc: segmented_objective_value(
            prob, controls, pc, target, order, n_segments=n_segments, **kw)
    elif gradient_route == "plain":
        oag = lambda pc: objective_and_gradient(prob, controls, pc, target,
                                                order, **kw)
        value_fn = lambda pc: objective_value(prob, controls, pc, target,
                                              order, **kw)
    elif gradient_route == "prefix":
        raise NotImplementedError(
            f"gradient_route='prefix' is not ported: {_PREFIX_ITEM}")
    else:
        raise ValueError(f"unknown gradient_route {gradient_route!r}")

    opt = _BatchedLBFGS(pcofs, lbfgs_history, ls_max_steps,
                        ls_decrease_factor, ls_increase_factor)
    objs = []
    for it in range(maxIter):
        (j1, guard, ridge), grad = oag(pcofs)
        vals = j1 + guard + ridge
        updates = opt.direction(pcofs, grad)
        lr = opt.step_size(pcofs, updates, vals, grad, value_fn)
        new = torch.clamp(pcofs + lr[:, None] * updates, lo, hi)
        # freeze converged starts
        pcofs = torch.where((vals < stop_objective)[:, None], pcofs, new)
        vals_np = vals.cpu().numpy()
        objs.append(vals_np)
        if print_level >= 5:
            print(f"iter {it:4d}  obj min {vals_np.min():.6e} "
                  f"median {np.median(vals_np):.3e}")
        if bool(np.all(vals_np < stop_objective)):
            break
    return pcofs, np.asarray(objs)


def gradient_descent(prob, controls, pcof_init, target, *, order: int = 4,
                     learning_rate: float = 0.01, max_iter: int = 100,
                     cost_type: str = "Infidelity"):
    """Fixed-step gradient descent ``pcof -= learning_rate * grad``."""
    from .adjoint import discrete_adjoint

    pcof = torch.as_tensor(pcof_init, dtype=torch.float64).to(prob.device)
    for _ in range(max_iter):
        grad = discrete_adjoint(prob, controls, pcof, target, order,
                                cost_type=cost_type)
        pcof = pcof - learning_rate * grad
    return pcof
