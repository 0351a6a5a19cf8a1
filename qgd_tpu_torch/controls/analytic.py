"""Piecewise-constant and piecewise-monomial GRAPE controls (counterpart of
``GRAPEControl``/``GeneralGRAPEControl`` in ``qgd_tpu.controls.analytic``).

``pcof = [p amplitudes; q amplitudes]``, ``N_amplitudes`` each, on uniform
intervals of width ``tf / N_amplitudes``; on its interval a pulse is
``amplitude * local_t ** monomial_order`` with ``local_t`` in ``[0, 1)``.
Closed form in ``t`` and linear in ``pcof``: the pcof gradient is autograd
through the amplitude gather.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .base import Control


def _region_index(ts: torch.Tensor, tf: float, n_regions: int):
    """Uniform-interval region index, clamped to ``[0, n_regions - 1]``
    (the same float64 arithmetic as the JAX package)."""
    idx = torch.floor(ts * (n_regions / tf)).to(torch.int64)
    return torch.clamp(idx, 0, n_regions - 1)


@dataclass(frozen=True)
class _GRAPE(Control):
    N_amplitudes: int = 1
    monomial_order: int = 0

    def _local(self, ts):
        width = self.tf / self.N_amplitudes
        idx = _region_index(ts, self.tf, self.N_amplitudes)
        local_t = (ts - idx.to(ts.dtype) * width) / width
        return idx, local_t, width

    def _table(self, ts, amplitudes, m: int):
        """``(..., T, m)``: ``d^k/dt^k [local_t^mo] / k!`` times the
        interval's amplitude, for ``amplitudes (..., N_amplitudes)``."""
        idx, local_t, width = self._local(ts)
        mo = self.monomial_order
        cols = []
        for k in range(m):
            if k > mo:
                cols.append(torch.zeros_like(local_t))
            else:
                cols.append(math.comb(mo, k) * local_t ** (mo - k)
                            / width ** k)
        return amplitudes[..., idx, None] * torch.stack(cols, dim=-1)

    def p_derivatives(self, ts, pcof, m: int):
        return self._table(ts, pcof[..., :self.N_amplitudes], m)

    def q_derivatives(self, ts, pcof, m: int):
        return self._table(ts, pcof[..., self.N_amplitudes:], m)


def GRAPEControl(N_amplitudes, tf):
    """Piecewise-constant control with ``N_amplitudes`` intervals."""
    return _GRAPE(N_coeff=2 * int(N_amplitudes), tf=float(tf),
                  N_amplitudes=int(N_amplitudes), monomial_order=0)


def GeneralGRAPEControl(N_amplitudes, tf, monomial_order):
    """Piecewise-monomial control of degree ``monomial_order``."""
    return _GRAPE(N_coeff=2 * int(N_amplitudes), tf=float(tf),
                  N_amplitudes=int(N_amplitudes),
                  monomial_order=int(monomial_order))
