"""State-vector helpers (counterpart of ``qgd_tpu.utils.states``; the
reference's ``src/state_vector_helpers.jl``), on torch tensors."""

from __future__ import annotations

import numpy as np
import torch


def get_populations(history):
    """Per-level populations ``|u|^2 + |v|^2``.

    Takes a real time-major history ``(T, 2N, B)`` (or ``(T, m+1, 2N, B)``
    with derivative columns, of which only the state column is used) and
    returns ``(T, N, B)``, as a tensor on the history's device."""
    history = torch.as_tensor(history)
    if history.dim() == 4:
        history = history[:, 0]
    n = history.shape[-2] // 2
    return history[..., :n, :] ** 2 + history[..., n:, :] ** 2


def target_helper(target, N_guard_levels: int = 0):
    """Realify a (possibly complex) essential-subspace target and pad it
    with guard levels: ``(2 (N_ess + N_guard), B)`` float64."""
    target = np.asarray(target)
    if target.ndim == 1:
        target = target[:, None]
    n_ess, n_ic = target.shape
    n_tot = n_ess + N_guard_levels
    out = np.zeros((2 * n_tot, n_ic))
    out[:n_ess, :] = np.real(target)
    out[n_tot:n_tot + n_ess, :] = np.imag(target)
    return torch.as_tensor(out)


def complex_to_real(x):
    """Stack ``[Re; Im]`` along the leading state dimension."""
    x = torch.as_tensor(x)
    if not x.is_complex():
        return torch.cat([x, torch.zeros_like(x)], dim=0)
    return torch.cat([x.real, x.imag], dim=0)


def real_to_complex(x, x_imag=None):
    """Inverse of :func:`complex_to_real` (or ``x + i x_imag``)."""
    x = torch.as_tensor(x)
    if x_imag is not None:
        return torch.complex(x, torch.as_tensor(x_imag, dtype=x.dtype,
                                                device=x.device))
    n = x.shape[0] // 2
    return torch.complex(x[:n], x[n:])


def initial_basis(N_ess: int, N_guard: int):
    """Essential-basis initial conditions padded with guard levels:
    ``(u0, v0)``, each ``(N_ess + N_guard, N_ess)`` float64."""
    u0 = torch.zeros((N_ess + N_guard, N_ess), dtype=torch.float64)
    u0[:N_ess] = torch.eye(N_ess, dtype=torch.float64)
    return u0, torch.zeros_like(u0)
