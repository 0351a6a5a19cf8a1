"""Carrier-wave wrapper (counterpart of ``qgd_tpu.controls.carrier``): any
base control modulated by a set of carrier frequencies.

With complex envelope ``e_f(t) = p_f(t) + i q_f(t)`` (one base-control
parameter block per frequency) and carrier ``exp(i w_f t)``, the pulse is
``P + iQ = sum_f e_f(t) exp(i w_f t)``. Its scaled derivative tables follow
by the Cauchy product of scaled Taylor coefficients::

    (e c)^{(k)}/k! = sum_{j<=k} (e^{(j)}/j!) ((i w)^{k-j}/(k-j)!) c

The arithmetic is the JAX package's real form of that product (the
quarter-phase cycle of ``i^k e^{iwt}`` and ``w^k`` by cumulative product),
vectorised over frequencies, times and control vectors, so the tables
agree with it to roundoff. The pcof gradient is autograd through it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .base import Control


@dataclass(frozen=True, eq=False)
class _Carrier(Control):
    base_control: Control
    carrier_frequencies: np.ndarray  # (N_freq,) float64
    N_freq: int

    @property
    def N_coeffs_per_frequency(self) -> int:
        return self.base_control.N_coeff

    def pq_derivatives(self, ts, pcof, m: int):
        """``(P, Q)`` tables ``(..., T, m)`` for ``pcof (..., N_coeff)``,
        built together: both come from one Cauchy product."""
        npc = self.base_control.N_coeff
        locals_ = pcof.reshape(pcof.shape[:-1] + (self.N_freq, npc))
        # (..., F, T, m) each
        ep, eq = self.base_control.pq_derivatives(ts, locals_, m)
        w = torch.as_tensor(self.carrier_frequencies, dtype=torch.float64,
                            device=ts.device)
        ks = torch.arange(m, device=ts.device)
        fact = torch.tensor([math.factorial(k) for k in range(m)],
                            dtype=torch.float64, device=ts.device)
        d = ks[:, None] - ks[None, :]
        tri = d >= 0
        dc = torch.clamp(d, min=0)
        th = w[:, None] * ts                                   # (F, T)
        c, s = torch.cos(th), torch.sin(th)
        re4 = torch.stack([c, -s, -c, s], dim=-1)              # (F, T, 4)
        im4 = torch.stack([s, c, -s, -c], dim=-1)
        # integer powers w^k by cumulative product, as in the JAX package
        wpow = torch.cat([torch.ones_like(w)[:, None],
                          torch.cumprod(w[:, None].expand(-1, m - 1), dim=-1)],
                         dim=-1)
        scale = (wpow / fact)[:, None, :]                      # (F, 1, m)
        cr = scale * re4[..., ks % 4]    # Re[(i w)^k/k! e^{iwt}]  (F, T, m)
        ci = scale * im4[..., ks % 4]    # Im[...]
        zero = torch.zeros((), dtype=torch.float64, device=ts.device)
        Cr = torch.where(tri, cr[..., dc], zero)               # (F, T, m, m)
        Ci = torch.where(tri, ci[..., dc], zero)
        ep, eq = ep[..., None], eq[..., None]
        # (ep + i eq) * (cr + i ci), truncated Cauchy product, summed over f
        P = (Cr @ ep - Ci @ eq)[..., 0].sum(dim=-3)
        Q = (Ci @ ep + Cr @ eq)[..., 0].sum(dim=-3)
        return P, Q

    def p_derivatives(self, ts, pcof, m: int):
        return self.pq_derivatives(ts, pcof, m)[0]

    def q_derivatives(self, ts, pcof, m: int):
        return self.pq_derivatives(ts, pcof, m)[1]


def CarrierControl(base_control: Control, carrier_frequencies):
    """Wrap ``base_control`` with carrier waves; pcof is one base-control
    block per frequency, concatenated."""
    freqs = np.asarray(carrier_frequencies, dtype=np.float64).reshape(-1)
    return _Carrier(
        N_coeff=base_control.N_coeff * freqs.shape[0],
        tf=base_control.tf,
        base_control=base_control,
        carrier_frequencies=freqs,
        N_freq=int(freqs.shape[0]),
    )
