"""Quadratic B-spline control (counterpart of ``qgd_tpu.controls.bspline``).

Uniform-knot quadratic B-spline with ``D1`` basis functions per quadrature
(``pcof = [p-coeffs; q-coeffs]``), knot spacing ``dtknot = tf/(D1-2)``,
centres ``dtknot*(k - 0.5)`` (0-based ``k``). At any ``t`` exactly three
basis functions are non-zero: splines ``k0, k0-1, k0-2`` with
``k0 = clip(ceil(t/dtknot) + 2, 3, D1) - 1``. Their closed-form values and
derivatives are evaluated over the whole time grid at once; the pcof
gradient is autograd through the 3-tap gather.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .base import Control


@dataclass(frozen=True)
class _BSpline2(Control):
    D1: int = 3

    @property
    def dtknot(self) -> float:
        return self.tf / (self.D1 - 2)

    def _segment_values(self, ts: torch.Tensor, derivative_order: int):
        """``(k0 (T,), vals (T, 3))``: the leading spline index and the
        contributions of splines ``k0, k0-1, k0-2`` (same float64 arithmetic
        as the JAX package, so every time lands in the same interval)."""
        dtknot = self.dtknot
        width = 3.0 * dtknot
        k = torch.ceil(ts / dtknot).to(torch.int64) + 2
        k0 = torch.clamp(k, 3, self.D1) - 1
        k0f = k0.to(torch.float64)

        def tau(offset):
            tc = dtknot * (k0f - offset - 0.5)
            return (ts - tc) / width

        t0, t1, t2 = tau(0.0), tau(1.0), tau(2.0)
        if derivative_order == 0:
            vals = (9.0 / 8.0 + 4.5 * t0 + 4.5 * t0 ** 2,
                    0.75 - 9.0 * t1 ** 2,
                    9.0 / 8.0 - 4.5 * t2 + 4.5 * t2 ** 2)
        elif derivative_order == 1:
            vals = ((4.5 + 9.0 * t0) / width,
                    (-18.0 * t1) / width,
                    (-4.5 + 9.0 * t2) / width)
        elif derivative_order == 2:
            vals = (torch.full_like(t0, 9.0 / width ** 2),
                    torch.full_like(t1, -18.0 / width ** 2),
                    torch.full_like(t2, 9.0 / width ** 2))
        else:
            vals = (torch.zeros_like(t0),) * 3
        return k0, vals

    def _eval(self, ts, coeffs, derivative_order: int):
        """``(..., T)`` values of the ``derivative_order``-th derivative for
        ``coeffs (..., D1)``."""
        k0, (v0, v1, v2) = self._segment_values(ts, derivative_order)
        return (v0 * coeffs[..., k0] + v1 * coeffs[..., k0 - 1]
                + v2 * coeffs[..., k0 - 2])

    def _table(self, ts, coeffs, m: int):
        return torch.stack([self._eval(ts, coeffs, k) / math.factorial(k)
                            for k in range(m)], dim=-1)

    def p_derivatives(self, ts, pcof, m: int):
        return self._table(ts, pcof[..., :self.D1], m)

    def q_derivatives(self, ts, pcof, m: int):
        return self._table(ts, pcof[..., self.D1:], m)


def BSpline2Control(D1, tf):
    """Quadratic B-spline control with ``D1 >= 3`` coefficients per pulse
    quadrature."""
    D1 = int(D1)
    if D1 < 3:
        raise ValueError(
            f"Number of coefficients per spline (D1 = {D1}) must be >= 3.")
    return _BSpline2(N_coeff=2 * D1, tf=float(tf), D1=D1)
