"""Analytic controls (counterpart of ``qgd_tpu.controls.analytic``): the
sine/cosine test families, the zero control, and the piecewise-constant
and piecewise-monomial GRAPE controls.

* The trig families have ``p = a_p trig_p(w t)``, ``q = a_q trig_q(w t)``
  with amplitudes ``a = pcof[i]`` (``pcof[i]**2`` for
  ``SquaredAmpCosControl``); their tables are exact at every order, the
  k-th scaled derivative of ``cos(w t)`` being ``w^k/k! cos(w t + k
  pi/2)``.
* GRAPE: ``pcof = [p amplitudes; q amplitudes]``, ``N_amplitudes`` each,
  on uniform intervals of width ``tf / N_amplitudes``; on its interval a
  pulse is ``amplitude * local_t ** monomial_order`` with ``local_t`` in
  ``[0, 1)``.

Each is closed form in ``t``; the pcof gradient is autograd through it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .base import Control


def _trig_scaled_derivs(w: float, ts, m: int, phase_cos: bool):
    """``(T, m)`` scaled derivatives of ``cos(w t)`` (``phase_cos``) or
    ``sin(w t)``: ``w^k/k! * trig(w t + k pi/2)``."""
    ks = torch.arange(m, dtype=torch.float64, device=ts.device)
    fact = torch.tensor([math.factorial(k) for k in range(m)],
                        dtype=torch.float64, device=ts.device)
    phase = w * ts[:, None] + ks * (math.pi / 2.0)
    base = torch.cos(phase) if phase_cos else torch.sin(phase)
    return (w ** ks) / fact * base


@dataclass(frozen=True)
class _SinCosFamily(Control):
    """``p = trig_p(w t) * amp(pcof[0])``, ``q = trig_q(w t) *
    amp(pcof[1])`` (``kind`` picks the trig functions and the amplitude
    map)."""
    frequency: float
    kind: str

    def _amp(self, pcof, idx: int):
        a = pcof[..., idx]
        return a ** 2 if self.kind == "squared_amp_cos" else a

    def p_derivatives(self, ts, pcof, m: int):
        tab = _trig_scaled_derivs(self.frequency, ts, m,
                                  self.kind not in ("sincos", "sin"))
        return self._amp(pcof, 0)[..., None, None] * tab

    def q_derivatives(self, ts, pcof, m: int):
        if self.kind == "single_sym_cos":
            return torch.zeros(pcof.shape[:-1] + (ts.shape[0], m),
                               dtype=torch.float64, device=ts.device)
        tab = _trig_scaled_derivs(self.frequency, ts, m, self.kind != "sin")
        return self._amp(pcof, 1)[..., None, None] * tab


def SinCosControl(tf, frequency=1.0):
    """``p = pcof[0] sin(w t)``, ``q = pcof[1] cos(w t)``."""
    return _SinCosFamily(N_coeff=2, tf=float(tf), frequency=float(frequency),
                         kind="sincos")


def SinControl(tf, frequency=1.0):
    """``p = pcof[0] sin(w t)``, ``q = pcof[1] sin(w t)``."""
    return _SinCosFamily(N_coeff=2, tf=float(tf), frequency=float(frequency),
                         kind="sin")


def CosControl(tf, frequency=1.0):
    """``p = pcof[0] cos(w t)``, ``q = pcof[1] cos(w t)``."""
    return _SinCosFamily(N_coeff=2, tf=float(tf), frequency=float(frequency),
                         kind="cos")


def SquaredAmpCosControl(tf, frequency=1.0):
    """``p = pcof[0]^2 cos(w t)``, ``q = pcof[1]^2 cos(w t)``: nonlinear in
    pcof."""
    return _SinCosFamily(N_coeff=2, tf=float(tf), frequency=float(frequency),
                         kind="squared_amp_cos")


def SingleSymCosControl(tf, frequency=1.0):
    """``p = pcof[0] cos(w t)``, ``q = 0``."""
    return _SinCosFamily(N_coeff=1, tf=float(tf), frequency=float(frequency),
                         kind="single_sym_cos")


@dataclass(frozen=True)
class _Zero(Control):
    def p_derivatives(self, ts, pcof, m: int):
        # the empty sum ties the zeros to pcof: a gradient through the
        # tables is then zero, not undefined
        zero = pcof[..., :0].sum(dim=-1)[..., None, None]
        return zero + torch.zeros(pcof.shape[:-1] + (ts.shape[0], m),
                                  dtype=torch.float64, device=ts.device)

    q_derivatives = p_derivatives


def ZeroControl(tf=1.0, N_coeff=0):
    """``p = q = 0``."""
    return _Zero(N_coeff=int(N_coeff), tf=float(tf))


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
