"""Gate infidelity, guard-penalty and ridge objective (counterpart of
``qgd_tpu.objective``). States are real-stacked ``(..., 2N, B)``; every
reduction is over the last two dimensions, so leading scenario dimensions
pass through. Objectives reduce in float64.

Gate-column sharding: every function here that reduces over the gate
columns takes ``ic_group``, a ``torch.distributed`` process group whose
ranks each hold some of the columns (``parallel.sharded``), or ``None``.
With a group, the column sums are ``all_reduce``d over it in float64
(:func:`ic_sum`) where the JAX package ``psum``s over its ``ic`` mesh
axis; with ``None`` nothing changes.
"""

from __future__ import annotations

import numpy as np
import torch

from .controls import as_control_tuple


def _target_T(target_real: torch.Tensor, N_tot: int) -> torch.Tensor:
    """Real-stacked ``i * target``: ``T = [R_v; -R_u]``."""
    return torch.cat([target_real[..., N_tot:, :],
                      -target_real[..., :N_tot, :]], dim=-2)


def _inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=(-2, -1))


def infidelity_real(psi_real, target_real, N_ess: int):
    """``1 - (<psi,R>^2 + <psi,T>^2)/N_ess^2`` for ``psi_real (..., 2N, B)``
    against ``target_real (2N, B)`` (Frobenius over the gate basis)."""
    N_tot = psi_real.shape[-2] // 2
    a = _inner(psi_real, target_real)
    b = _inner(psi_real, _target_T(target_real, N_tot))
    return 1.0 - (a * a + b * b) / (N_ess ** 2)


def host_realify_target(target) -> np.ndarray:
    """Complex target gate -> real-stacked ``[Re; Im]`` float64 numpy
    ``(2N, B)`` (idempotent on real targets; 1-D becomes one column)."""
    if isinstance(target, torch.Tensor):
        target = target.detach().cpu().numpy()
    t = np.asarray(target)
    if np.iscomplexobj(t):
        t = np.concatenate([t.real, t.imag], axis=0)
    t = t.astype(np.float64)
    if t.ndim == 1:
        t = t[:, None]
    return t


def target_on_device(prob, target) -> torch.Tensor:
    """The real-stacked float64 target ``(2N, B)`` on ``prob.device``."""
    return torch.as_tensor(host_realify_target(target), device=prob.device)


def infidelity_of(prob, controls, pcof, target, order: int = 2,
                  forcing=None):
    """Forward solve, then the infidelity of its final state against
    ``target`` (``src/infidelity.jl:33-47``): a float64 scalar, ``(S,)``
    for ``pcof (S, N_params)``."""
    from .forward import eval_forward

    hist = eval_forward(prob, controls, pcof, order, forcing=forcing)
    return infidelity_real(hist[..., -1, :, :].to(torch.float64),
                           target_on_device(prob, target), prob.N_ess_levels)


def ridge_penalty(pcof, strength: float):
    """``strength * ||pcof||^2 / N_params`` per control vector."""
    return strength * torch.sum(pcof * pcof, dim=-1) / pcof.shape[-1]


def ic_sum(x, ic_group):
    """``x`` summed over the ranks of the process group ``ic_group`` in
    float64 (``x`` itself when ``ic_group`` is None); ``x`` is left as it
    was."""
    if ic_group is None:
        return x
    import torch.distributed as dist

    total = x.to(torch.float64, copy=True).contiguous()
    dist.all_reduce(total, group=ic_group)
    return total


def terminal_cost(final_state, target_real, N_ess: int,
                  cost_type: str = "Infidelity", ic_group=None):
    """Terminal cost ``J1(w_N)``: ``Infidelity`` (default), ``Tracking``
    ``0.5 ||w_N - target||^2`` or ``Norm`` ``0.5 ||w_N||^2``. With
    ``ic_group`` the value is that of all the group's columns."""
    if ic_group is not None:
        return terminal_cost_and_grad(final_state, target_real, N_ess,
                                      cost_type, ic_group)[0]
    if cost_type == "Infidelity":
        return infidelity_real(final_state, target_real, N_ess)
    if cost_type == "Tracking":
        d = final_state - target_real
        return 0.5 * _inner(d, d)
    if cost_type == "Norm":
        return 0.5 * _inner(final_state, final_state)
    raise ValueError(f"Invalid cost type: {cost_type}")


def terminal_cost_and_grad(final_state, target_real, N_ess: int,
                           cost_type: str = "Infidelity", ic_group=None):
    """``(J1, dJ1/d final_state)`` in closed form.

    With ``ic_group`` the rank holds some gate columns of ``final_state``
    and ``target_real``: the infidelity's traces ``a``, ``b`` are summed
    over the group before the value and this rank's columns of the
    gradient are formed (the only coupling between columns is through
    them); the Tracking and Norm costs are separable by column, so only
    their value is summed."""
    if cost_type == "Infidelity":
        N_tot = final_state.shape[-2] // 2
        R = target_real
        T = _target_T(target_real, N_tot)
        a = _inner(final_state, R)
        b = _inner(final_state, T)
        if ic_group is not None:
            a, b = ic_sum(torch.stack([a, b]), ic_group)
        val = 1.0 - (a * a + b * b) / (N_ess ** 2)
        g = (-2.0 / N_ess ** 2) * (a[..., None, None] * R
                                   + b[..., None, None] * T)
        return val, g
    if cost_type == "Tracking":
        d = final_state - target_real
        return ic_sum(0.5 * _inner(d, d), ic_group), d
    if cost_type == "Norm":
        return (ic_sum(0.5 * _inner(final_state, final_state), ic_group),
                final_state)
    raise ValueError(f"Invalid cost type: {cost_type}")


def infidelity(psi, target, N_ess: int):
    """Complex-argument wrapper of :func:`infidelity_real`: ``psi`` and
    ``target`` are ``(..., N, B)`` (or ``(N,)``) complex."""
    psi = torch.as_tensor(psi)
    target = torch.as_tensor(target)
    if psi.dim() == 1:
        psi, target = psi[:, None], target[:, None]
    psi_r = torch.cat([psi.real, psi.imag], dim=-2).to(torch.float64)
    tgt_r = torch.cat([target.real, target.imag], dim=-2).to(torch.float64)
    return infidelity_real(psi_r, tgt_r.to(psi_r.device), N_ess)


def guard_penalty_real(history, dt, total_time, W):
    """Trapezoid in time of ``<w, W w> * dt/T`` over the state history
    ``(..., T, 2N, B)`` (any float dtype), reduced in float64 in chunks of
    time points -> ``(...)``."""
    from .forward import _chunks

    W = torch.as_tensor(W, dtype=torch.float64).to(history.device)
    T = history.shape[-3]
    per_t = torch.empty(history.shape[:-2], dtype=torch.float64,
                        device=history.device)
    for a, b in _chunks(T, int(np.prod(history.shape[:-3], dtype=np.int64))):
        h = history[..., a:b, :, :].to(torch.float64)
        per_t[..., a:b] = torch.sum(h * (W @ h), dim=(-2, -1))
    weights = torch.ones(T, dtype=torch.float64, device=history.device)
    weights[0] = weights[-1] = 0.5
    return torch.sum(weights * per_t, dim=-1) * dt / total_time


def guard_penalty(history_complex, dt, total_time, W):
    """Complex wrapper: history ``(..., T, N, B)``."""
    h = torch.as_tensor(history_complex)
    return guard_penalty_real(torch.cat([h.real, h.imag], dim=-2), dt,
                              total_time, W)


def objective_parts(prob, controls, pcof, target, order: int = 2,
                    ridge_penalty_strength: float = 0.0,
                    cost_type: str = "Infidelity"):
    """``(terminal cost, guard penalty, ridge)`` from one forward solve of
    the plain route, each ``(S,)`` for ``pcof (S, N_params)`` (scalars for
    a 1-D ``pcof``). The ridge term is ``lambda_r ||pcof||^2 / N_params``.
    Differentiable by autograd when ``pcof`` requires grad."""
    from .forward import _scenario_pcof, eval_forward

    controls = as_control_tuple(controls)
    pcof, single = _scenario_pcof(prob, pcof)
    hist = eval_forward(prob, controls, pcof, order)
    j1 = terminal_cost(hist[:, -1].to(torch.float64),
                       target_on_device(prob, target), prob.N_ess_levels,
                       cost_type)
    guard = guard_penalty_real(hist, prob.tf / prob.nsteps, prob.tf,
                               prob.guard_subspace_projector)
    ridge = ridge_penalty(pcof, ridge_penalty_strength)
    if single:
        return j1[0], guard[0], ridge[0]
    return j1, guard, ridge


def objective_value(prob, controls, pcof, target, order: int = 2,
                    ridge_penalty_strength: float = 0.0,
                    cost_type: str = "Infidelity"):
    """Total objective (infidelity + guard + ridge)."""
    j1, guard, ridge = objective_parts(
        prob, controls, pcof, target, order, ridge_penalty_strength,
        cost_type)
    return j1 + guard + ridge


def infidelity_plus_guard(prob, controls, pcof, target, order: int = 2):
    """Terminal infidelity plus guard penalty."""
    j1, guard, _ = objective_parts(prob, controls, pcof, target, order)
    return j1 + guard
