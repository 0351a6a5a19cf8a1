"""Hermite-Obreshkov (two-point Taylor) timestep core, batched
(counterpart of ``qgd_tpu.ops.hermite``).

The order-``2m`` one-step relation is::

    sum_{j=0}^{m} (-dt)^j c_jm W_j(t_{n+1})  =  sum_{j=0}^{m} dt^j c_jm W_j(t_n)

with ``c_jm = m! (2m-j)! / ((2m)! (m-j)!)`` and the scaled derivatives
``W_j = w^{(j)}/j!`` from the Leibniz recursion
``W_{j+1} = 1/(j+1) sum_{i<=j} A~_{j-i} W_i``. Every function takes any
number of leading batch dimensions (scenarios, time points) in front of
the JAX package's shapes.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch


def hermite_coefficient(j: int, p: int, q: int) -> float:
    """Hermite/Pade weight ``c_j = p! (p+q-j)! / ((p+q)! (p-j)!)``."""
    return (math.factorial(p) * math.factorial(p + q - j)
            / (math.factorial(p + q) * math.factorial(p - j)))


@lru_cache(maxsize=None)
def hermite_coefficients(m: int) -> tuple:
    """The weights ``c_jm`` for ``j = 0..m``."""
    return tuple(hermite_coefficient(j, m, m) for j in range(m + 1))


def assemble_generator_stack(prob, p_vals: torch.Tensor,
                             q_vals: torch.Tensor, m: int) -> torch.Tensor:
    """Stacked scaled generator derivatives ``A~_k`` (k = 0..m-1).

    ``p_vals``/``q_vals`` are ``(..., m, N_ops)`` tables; returns
    ``(..., m, 2N, 2N)`` with ``A~_k = [[S_k, K_k], [-K_k, S_k]]``,
    ``S_k = delta_k0 S_drift + sum_j q[k, j] asym_op[j]`` and
    ``K_k = delta_k0 K_drift + sum_j p[k, j] sym_op[j]``.
    """
    N = prob.N_tot_levels
    if prob.N_operators > 0:
        S = torch.einsum("...kj,jab->...kab", q_vals, prob.asym_operators)
        K = torch.einsum("...kj,jab->...kab", p_vals, prob.sym_operators)
    else:
        shape = p_vals.shape[:-1] + (N, N)
        S = torch.zeros(shape, dtype=prob.system_sym.dtype,
                        device=p_vals.device)
        K = torch.zeros_like(S)
    # in place on the fresh einsum outputs: the drift enters level 0 only
    S[..., 0, :, :] += prob.system_asym
    K[..., 0, :, :] += prob.system_sym
    top = torch.cat([S, K], dim=-1)
    bot = torch.cat([-K, S], dim=-1)
    return torch.cat([top, bot], dim=-2)


def scaled_derivatives(A_stack: torch.Tensor, W0: torch.Tensor,
                       m: int) -> torch.Tensor:
    """Leibniz recursion: ``A_stack (..., m, n, n)``, ``W0 (..., n, b)`` ->
    ``(..., m+1, n, b)`` scaled derivatives (``W0`` broadcasts, so the
    identity gives the dense one-step matrices)."""
    Ws = [W0]
    for j in range(m):
        acc = A_stack[..., j, :, :] @ Ws[0]
        for i in range(1, j + 1):
            acc = acc + A_stack[..., j - i, :, :] @ Ws[i]
        Ws.append(acc / (j + 1))
    Ws = torch.broadcast_tensors(*Ws)
    return torch.stack(Ws, dim=-3)


def build_rhs(W_derivs: torch.Tensor, dt, m: int) -> torch.Tensor:
    """Explicit side ``sum_j dt^j c_jm W_j``; ``W_derivs`` is
    ``(..., m+1, n, b)``, ``dt`` a Python float or 0-d tensor (the powers
    are formed in ``W_derivs.dtype``, as in the JAX package)."""
    c = hermite_coefficients(m)
    acc = c[0] * W_derivs[..., 0, :, :]
    dt_pow = torch.ones((), dtype=W_derivs.dtype, device=W_derivs.device)
    for j in range(1, m + 1):
        dt_pow = dt_pow * dt
        acc = acc + (c[j] * dt_pow) * W_derivs[..., j, :, :]
    return acc


def build_lhs(W_derivs: torch.Tensor, dt, m: int) -> torch.Tensor:
    """Implicit side ``sum_j (-dt)^j c_jm W_j``."""
    return build_rhs(W_derivs, -dt, m)
