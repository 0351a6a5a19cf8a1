"""Optimizer drivers (counterpart of ``qgd_tpu.optimize``).

* :func:`optimize_gate`: one control vector, minimizing ``infidelity +
  guard penalty + ridge``; each evaluation is one objective + gradient
  call on ``prob.device``. ``method="lbfgsb"`` is scipy L-BFGS-B on the
  host (one float64 copy of the result per evaluation);
  ``method="lbfgs"`` is optax's ``lbfgs`` (its ``scale_by_lbfgs`` memory
  and the default strong-Wolfe zoom line search) written in torch, with
  the iterate projected on the box bounds.
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


def _check_options(method: str, gradient_route: str,
                   max_dispatch_steps: int):
    if method not in ("lbfgsb", "lbfgs"):
        raise ValueError(f"unknown method {method!r}")
    if gradient_route not in ("auto", "prefix"):
        raise ValueError(f"unknown gradient_route {gradient_route!r}")
    if method == "lbfgs" and max_dispatch_steps > 0:
        # the JAX package's refusal, kept for parity: there optax's zoom
        # line search traces its value function, which the host loop of
        # the chunked route cannot serve
        raise ValueError(
            "method='lbfgs' (on-device optax) cannot drive the "
            "host-chunked evaluator (max_dispatch_steps > 0): the "
            "zoom linesearch traces its value_fn. Use the default "
            "method='lbfgsb' for chunked long-horizon runs.")


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
    """Optimize one control vector: scipy L-BFGS-B (``method="lbfgsb"``)
    or L-BFGS on the device with projected box bounds (``"lbfgs"``).

    ``pcof_L``/``pcof_U``: box bounds, scalar or per-parameter vector.
    ``resume_from``: a history checkpoint basename; restarts from its last
    pcof and appends to the loaded history. ``filename``: the setup
    (:func:`~qgd_tpu_torch.checkpoint.save_setup`) is written once and the
    history after every evaluation. ``n_segments``: ``None`` picks the
    plain route below 16384 steps and the segmented route (automatic
    segment count) above, ``0`` forces the plain route, ``> 0`` the
    segmented route with that many segments. ``gradient_route="prefix"``
    takes the prefix-product route (:mod:`qgd_tpu_torch.prefix`, the
    single-run latency route; ``n_segments > 0`` sets its segment count).
    ``max_dispatch_steps > 0`` takes the host-chunked route
    (:mod:`qgd_tpu_torch.chunked`: at most that many steps per chunk,
    segment programs replayed as CUDA graphs captured once per run) for
    every evaluation, with ``n_segments > 0`` as its segment count and
    the automatic count otherwise; ``method="lbfgsb"`` only, as in JAX.
    The loop stops once the objective drops below ``stop_objective`` or
    the wall time passes ``max_cpu_time``. Returns the
    :class:`OptimizationHistory`.
    """
    from .adjoint import objective_and_gradient
    from .chunked import chunked_objective_and_gradient
    from .prefix import prefix_objective_and_gradient
    from .segmented import SegmentGraphs, segmented_objective_and_gradient

    _check_options(method, gradient_route, max_dispatch_steps)
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
    # the chunked and segmented routes' programs: captured once, replayed
    # at every evaluation
    graphs = SegmentGraphs()

    def value_parts_and_grad(pc):
        pct = torch.as_tensor(pc, dtype=torch.float64, device=prob.device)
        if max_dispatch_steps > 0:
            (j1, guard, ridge), grad = chunked_objective_and_gradient(
                prob, controls, pct, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength,
                n_segments=max(n_segments, 0),
                max_dispatch_steps=max_dispatch_steps, graphs=graphs)
        elif gradient_route == "prefix":
            (j1, guard, ridge), grad = prefix_objective_and_gradient(
                prob, controls, pct, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength,
                n_segments=max(n_segments, 0))
        elif n_segments == 0:
            (j1, guard, ridge), grad = objective_and_gradient(
                prob, controls, pct, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength)
        else:
            (j1, guard, ridge), grad = segmented_objective_and_gradient(
                prob, controls, pct, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength,
                n_segments=max(n_segments, 0), graphs=graphs)
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

    try:
        if method == "lbfgsb":
            from scipy.optimize import minimize

            minimize(eval_and_record, pcof0, jac=True, method="L-BFGS-B",
                     bounds=list(zip(lower, upper)),
                     options=dict(maxiter=maxIter, maxcor=lbfgs_history,
                                  ftol=1e-18, gtol=tol))
        else:
            def silent(pc):
                val, _, grad = value_parts_and_grad(pc)
                return float(val), torch.as_tensor(grad, device=prob.device)

            _lbfgs_loop(eval_and_record, silent, pcof0, lower, upper,
                        maxIter, lbfgs_history, prob.device)
    except _StopOptimization:
        pass

    if print_level >= 3:
        print(history.summary())
    return history


def _lbfgs_loop(eval_and_record, value_and_grad, pcof0, lower, upper,
                max_iter: int, memory: int, device):
    """optax ``lbfgs(memory_size=memory)`` (``scale_by_lbfgs`` with
    ``scale_init_precond``, ``scale(-1)``, the default
    ``scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy="one")``) on one control vector on ``device``,
    each iterate clipped to ``[lower, upper]``. ``eval_and_record`` makes
    the history's one entry per iteration; the line-search probes call
    ``value_and_grad`` (``(float, tensor)``), which records nothing."""
    pc = torch.as_tensor(pcof0, dtype=torch.float64, device=device)
    lo = torch.as_tensor(lower, dtype=torch.float64, device=device)
    hi = torch.as_tensor(upper, dtype=torch.float64, device=device)
    # the L-BFGS memory and direction only: its backtracking search is the
    # multistart's, not used here
    opt = _BatchedLBFGS(pc[None], memory, 0, 1.0, 1.0)
    for _ in range(max_iter):
        val, grad = eval_and_record(pc.cpu().numpy())
        grad = torch.as_tensor(grad, dtype=torch.float64, device=device)
        updates = opt.direction(pc[None], grad[None])[0]
        step = _zoom_linesearch(value_and_grad, pc, updates, float(val),
                                grad)
        pc = torch.minimum(torch.maximum(pc + step * updates, lo), hi)


def _zoom_linesearch(value_and_grad, params, updates, value: float, grad,
                     max_steps: int = 20, tol: float = 0.0,
                     increase_factor: float = 2.0, slope_rtol: float = 1e-4,
                     curv_rtol: float = 0.9, approx_dec_rtol: float = 1e-6,
                     interval_threshold: float = 1e-5) -> float:
    """optax's ``zoom_linesearch`` with its defaults and initial step 1:
    the step size along ``updates`` from ``params`` that meets the strong
    Wolfe conditions (sufficient decrease, with the approximate-decrease
    variant, and curvature), found by growing the step until an interval
    brackets one and then zooming in by cubic, quadratic or bisection
    steps; if it fails, the best step with sufficient decrease (or 0 if
    every probe was non-finite). The scalars are float64 numbers on the
    host (each decision needs them there); ``value_and_grad(p)`` returns
    the objective and gradient at ``p``."""
    f = np.float64
    inf = f(np.inf)
    slope_init = f(torch.sum(updates * grad).item())
    value_init = f(value)

    def on_line(step):
        v, g = value_and_grad(params + float(step) * updates)
        return f(v), g, f(torch.sum(g * updates).item())

    def decrease_error(step, v, s):
        err = v - value_init - slope_rtol * step * slope_init
        approx = np.maximum(s - (2 * slope_rtol - 1.0) * slope_init,
                            v - value_init - approx_dec_rtol
                            * np.abs(value_init))
        err = np.maximum(np.minimum(approx, err), 0.0)
        return inf if np.isnan(err) else err

    def curvature_error(s):
        err = np.maximum(np.abs(s) - curv_rtol * np.abs(slope_init), 0.0)
        return inf if np.isnan(err) else err

    count, stepsize, cur_v, cur_s = 0, f(0.0), value_init, slope_init
    dec_err = inf
    interval_found = done = failed = False
    low, v_low, s_low = f(0.0), value_init, slope_init
    high, v_high, s_high = f(0.0), value_init, slope_init
    c_ref, v_c_ref = f(0.0), value_init
    safe, safe_v = f(0.0), value_init
    with np.errstate(all="ignore"):
        while not (done or failed):
            if not interval_found:
                new = f(1.0) if count == 0 else increase_factor * stepsize
                v, _, s = on_line(new)
                dec_err = decrease_error(new, v, s)
                err = np.maximum(dec_err, curvature_error(s))
                if dec_err <= tol:
                    safe, safe_v = new, v
                set_high = (dec_err > 0.0) or (v >= cur_v and count > 0)
                set_low = s >= 0.0 and not set_high
                if set_low:
                    low, v_low, s_low = new, v, s
                    high, v_high, s_high = stepsize, cur_v, cur_s
                else:
                    low, v_low, s_low = stepsize, cur_v, cur_s
                    high, v_high, s_high = new, v, s
                interval_found = set_high or set_low or err <= tol
                done = bool(err <= tol)
                failed = count + 1 >= max_steps and not done
                c_ref, v_c_ref = low, v_low
            else:
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                mid_c = _cubicmin(low, v_low, s_low, high, v_high, c_ref,
                                  v_c_ref)
                mid_q = _quadmin(low, v_low, s_low, high, v_high)
                if left + 0.2 * delta < mid_c < right - 0.2 * delta:
                    new = mid_c
                elif left + 0.1 * delta < mid_q < right - 0.1 * delta:
                    new = mid_q
                else:
                    new = (low + high) / 2.0
                v, _, s = on_line(new)
                dec_err = decrease_error(new, v, s)
                err = np.maximum(dec_err, curvature_error(s))
                if dec_err <= tol and v < safe_v:
                    safe, safe_v = new, v
                done = bool(err <= tol)
                set_high_mid = dec_err > 0.0 or v >= v_low
                set_high_low = s * (high - low) >= 0.0 and not set_high_mid
                if set_high_mid or set_high_low:
                    c_ref, v_c_ref = high, v_high
                else:
                    c_ref, v_c_ref = low, v_low
                if set_high_mid:
                    high, v_high, s_high = new, v, s
                elif set_high_low:
                    high, v_high, s_high = low, v_low, s_low
                if not set_high_mid:
                    low, v_low, s_low = new, v, s
                failed = (count + 1 >= max_steps
                          or (delta <= interval_threshold and safe > 0.0)
                          ) and not done
            count += 1
            stepsize, cur_v, cur_s = new, v, s
            if failed and (safe > 0.0 or np.isinf(dec_err)):
                stepsize = safe
    return float(stepsize)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through ``(a, fa)`` with slope ``fpa``,
    ``(b, fb)`` and ``(c, fc)`` (optax's ``_cubicmin``; NaN where there is
    none)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    x, y = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * x + -(db ** 2) * y) / denom
    B = (-(dc ** 3) * x + db ** 3 * y) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * C)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through ``(a, fa)`` with slope ``fpa``
    and ``(b, fb)`` (optax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / db ** 2
    return a - fpa / (2.0 * B)


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
    are frozen. ``gradient_route``: ``"plain"`` (the Lagrange route),
    ``"segmented"`` or ``"prefix"``, the last two with ``n_segments``
    segments (0: their automatic rule).
    ``prob.hoist_batch_hint`` is raised to S.

    Returns ``(pcofs (S, n), objs (iterations, S))``: the final parameters
    (on ``prob.device``) and the objective at the start of each iteration
    (numpy).
    """
    import dataclasses

    from .adjoint import objective_and_gradient
    from .objective import objective_value
    from .prefix import prefix_objective_and_gradient, prefix_objective_value
    from .segmented import (SegmentGraphs, segmented_objective_and_gradient,
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
        # one set of programs per batch size, kept across iterations: the
        # line search's first probe shares the gradient call's forward
        kw["graphs"] = SegmentGraphs()
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
        oag = lambda pc: prefix_objective_and_gradient(
            prob, controls, pc, target, order, n_segments=n_segments, **kw)
        value_fn = lambda pc: prefix_objective_value(
            prob, controls, pc, target, order, n_segments=n_segments, **kw)
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
