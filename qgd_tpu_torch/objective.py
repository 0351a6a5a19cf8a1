"""Gate infidelity and terminal costs (counterpart of the parts of
``qgd_tpu.objective`` the ported gradient uses). States are real-stacked
``(..., 2N, B)``; every reduction is over the last two dimensions, so
leading scenario dimensions pass through.
"""

from __future__ import annotations

import numpy as np
import torch


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


def terminal_cost(final_state, target_real, N_ess: int,
                  cost_type: str = "Infidelity"):
    """Terminal cost ``J1(w_N)``: ``Infidelity`` (default), ``Tracking``
    ``0.5 ||w_N - target||^2`` or ``Norm`` ``0.5 ||w_N||^2``."""
    if cost_type == "Infidelity":
        return infidelity_real(final_state, target_real, N_ess)
    if cost_type == "Tracking":
        d = final_state - target_real
        return 0.5 * _inner(d, d)
    if cost_type == "Norm":
        return 0.5 * _inner(final_state, final_state)
    raise ValueError(f"Invalid cost type: {cost_type}")


def terminal_cost_and_grad(final_state, target_real, N_ess: int,
                           cost_type: str = "Infidelity"):
    """``(J1, dJ1/d final_state)`` in closed form."""
    if cost_type == "Infidelity":
        N_tot = final_state.shape[-2] // 2
        R = target_real
        T = _target_T(target_real, N_tot)
        a = _inner(final_state, R)
        b = _inner(final_state, T)
        val = 1.0 - (a * a + b * b) / (N_ess ** 2)
        g = (-2.0 / N_ess ** 2) * (a[..., None, None] * R
                                   + b[..., None, None] * T)
        return val, g
    if cost_type == "Tracking":
        d = final_state - target_real
        return 0.5 * _inner(d, d), d
    if cost_type == "Norm":
        return 0.5 * _inner(final_state, final_state), final_state
    raise ValueError(f"Invalid cost type: {cost_type}")
