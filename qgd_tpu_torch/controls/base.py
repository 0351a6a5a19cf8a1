"""Control-pulse protocol (counterpart of ``qgd_tpu.controls.base``).

A control has ``N_coeff`` parameters and a final time ``tf``. What the
propagator consumes is the scaled derivative table ``p^{(k)}(t)/k!`` for
``k = 0..m-1``, evaluated over a whole time grid and over a batch of
control vectors at once: ``pcof`` carries the scenarios as its leading
dimensions, ``(..., N_params)``. Each control owns a contiguous slice of
the last dimension, in the order the controls are given.

pcof gradients are not part of the protocol: the tables are built with
differentiable torch ops, so autograd through :func:`control_tables` is
the chain rule. The scalar API (``eval_p``, ``eval_p_derivative``,
``eval_grad_p_derivative`` and their ``q`` forms) reads the same tables.
"""

from __future__ import annotations

import math
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

    def pq_derivatives(self, ts: torch.Tensor, pcof: torch.Tensor, m: int):
        """Both tables ``(p, q)``. A control whose two tables share their
        work overrides this to build them in one pass."""
        return self.p_derivatives(ts, pcof, m), self.q_derivatives(ts, pcof, m)


def taylor_coefficients(f, t, m: int) -> torch.Tensor:
    """Scaled Taylor coefficients ``f^{(k)}(t)/k!``, ``k = 0..m-1``, of an
    elementwise function ``f`` of the times ``t`` (a number or a tensor),
    by nested forward-mode AD: ``(..., m)``, float64."""
    t = torch.as_tensor(t, dtype=torch.float64)
    if m <= 0:
        return torch.zeros(t.shape + (0,), dtype=torch.float64)
    derivs = [f(t)]
    g = f
    fact = 1.0
    for k in range(1, m):
        g = _scalar_derivative(g)
        fact *= k
        derivs.append(g(t) / fact)
    return torch.stack([torch.as_tensor(d, dtype=torch.float64)
                        for d in derivs], dim=-1)


def _scalar_derivative(f):
    def df(t):
        return torch.func.jvp(f, (t,), (torch.ones_like(t),))[1]
    return df


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


def local_control_index(controls, global_index: int) -> tuple[int, int]:
    """Map a global pcof index to ``(control_index, local_index)``, both
    0-based."""
    controls = as_control_tuple(controls)
    for ci, c in enumerate(controls):
        if global_index < c.N_coeff:
            return ci, global_index
        global_index -= c.N_coeff
    raise IndexError("global pcof index out of range")


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
        p, q = ctrl.pq_derivatives(ts, control_vector_slice(pcof, controls,
                                                            ci), m)
        ps.append(p)
        qs.append(q)
    return torch.stack(ps, dim=-1), torch.stack(qs, dim=-1)


def control_tables_at(controls, pcof: torch.Tensor, t: float, m: int):
    """Tables ``(P, Q)`` of shape ``(..., m, N_ops)`` at the single time
    ``t``."""
    ts = torch.tensor([float(t)], dtype=torch.float64, device=pcof.device)
    P, Q = control_tables(controls, pcof, ts, m)
    return P[..., 0, :, :], Q[..., 0, :, :]


# ---------------------------------------------------------------------------
# Scalar API: one control, one time
# ---------------------------------------------------------------------------

def _table_at(control: Control, t, pcof, m: int, which: int):
    pcof = torch.as_tensor(pcof, dtype=torch.float64)
    ts = torch.tensor([float(t)], dtype=torch.float64, device=pcof.device)
    return control.pq_derivatives(ts, pcof, m)[which][..., 0, :]


def eval_p(control: Control, t, pcof):
    """``p(t)`` of one control at the control vector ``pcof``."""
    return _table_at(control, t, pcof, 1, 0)[..., 0]


def eval_q(control: Control, t, pcof):
    """``q(t)`` of one control at the control vector ``pcof``."""
    return _table_at(control, t, pcof, 1, 1)[..., 0]


def eval_p_derivative(control: Control, t, pcof, order: int):
    """Unscaled ``order``-th time derivative ``p^{(order)}(t)``."""
    return (_table_at(control, t, pcof, order + 1, 0)[..., order]
            * math.factorial(order))


def eval_q_derivative(control: Control, t, pcof, order: int):
    """Unscaled ``order``-th time derivative ``q^{(order)}(t)``."""
    return (_table_at(control, t, pcof, order + 1, 1)[..., order]
            * math.factorial(order))


def _grad_wrt_pcof(fn, pcof):
    with torch.enable_grad():
        pc = torch.as_tensor(pcof, dtype=torch.float64).detach()
        pc.requires_grad_(True)
        (g,) = torch.autograd.grad(fn(pc), pc)
    return g


def eval_grad_p_derivative(control: Control, t, pcof, order: int):
    """Gradient of ``p^{(order)}(t)`` with respect to ``pcof``."""
    return _grad_wrt_pcof(
        lambda pc: eval_p_derivative(control, t, pc, order), pcof)


def eval_grad_q_derivative(control: Control, t, pcof, order: int):
    """Gradient of ``q^{(order)}(t)`` with respect to ``pcof``."""
    return _grad_wrt_pcof(
        lambda pc: eval_q_derivative(control, t, pc, order), pcof)
