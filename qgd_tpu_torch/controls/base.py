"""Control-pulse protocol (counterpart of ``qgd_tpu.controls.base``).

A control has ``N_coeff`` parameters and a final time ``tf``. What the
propagator consumes is the scaled derivative table ``p^{(k)}(t)/k!`` for
``k = 0..m-1``, evaluated over a whole time grid and over a batch of
control vectors at once: ``pcof`` carries the scenarios as its leading
dimensions, ``(..., N_params)``. Each control owns a contiguous slice of
the last dimension, in the order the controls are given.

pcof gradients are not part of the protocol: the tables are built with
differentiable torch ops, so autograd through :func:`control_tables` is
the chain rule.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Control:
    """Abstract pulse parameterization. Subclasses implement
    :meth:`p_derivatives` and :meth:`q_derivatives`."""

    N_coeff: int
    tf: float

    def p_derivatives(self, ts: torch.Tensor, pcof: torch.Tensor,
                      m: int) -> torch.Tensor:
        """``(..., T, m)`` table of ``p^{(k)}(t)/k!`` at the times ``ts (T,)``
        for the control vectors ``pcof (..., N_coeff)``."""
        raise NotImplementedError

    def q_derivatives(self, ts: torch.Tensor, pcof: torch.Tensor,
                      m: int) -> torch.Tensor:
        raise NotImplementedError


def as_control_tuple(controls) -> tuple:
    """Accept a bare control where a sequence is expected."""
    if isinstance(controls, Control):
        return (controls,)
    return tuple(controls)


def total_control_parameters(controls) -> int:
    """Total pcof length."""
    return sum(c.N_coeff for c in as_control_tuple(controls))


def control_vector_slice(pcof, controls, control_index: int):
    """Slice of the last dimension of ``pcof`` owned by control
    ``control_index`` (0-based)."""
    controls = as_control_tuple(controls)
    start = sum(c.N_coeff for c in controls[:control_index])
    return pcof[..., start:start + controls[control_index].N_coeff]


def control_tables(controls, pcof: torch.Tensor, ts, m: int):
    """Tables ``(P, Q)`` of shape ``(..., T, m, N_ops)`` with
    ``P[..., t, k, j] = p_j^{(k)}(ts[t])/k!`` for the control vectors
    ``pcof (..., N_params)`` (float64)."""
    controls = as_control_tuple(controls)
    ts = torch.as_tensor(ts, dtype=torch.float64, device=pcof.device)
    if not controls:
        shape = pcof.shape[:-1] + (ts.shape[0], m, 0)
        zeros = torch.zeros(shape, dtype=torch.float64, device=pcof.device)
        return zeros, zeros.clone()
    ps, qs = [], []
    for ci, ctrl in enumerate(controls):
        local = control_vector_slice(pcof, controls, ci)
        ps.append(ctrl.p_derivatives(ts, local, m))
        qs.append(ctrl.q_derivatives(ts, local, m))
    return torch.stack(ps, dim=-1), torch.stack(qs, dim=-1)


def control_tables_at(controls, pcof: torch.Tensor, t: float, m: int):
    """Tables ``(P, Q)`` of shape ``(..., m, N_ops)`` at the single time
    ``t``."""
    ts = torch.tensor([float(t)], dtype=torch.float64, device=pcof.device)
    P, Q = control_tables(controls, pcof, ts, m)
    return P[..., 0, :, :], Q[..., 0, :, :]
