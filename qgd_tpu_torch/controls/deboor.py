"""Arbitrary-degree clamped B-spline controls via the de Boor recurrence
(counterpart of ``qgd_tpu.controls.deboor``: ``GeneralBSplineControl`` and
``FortranBSplineControl``).

Knots: uniform distinct knots on ``[0, 1]`` with the first and last
repeated ``order`` times (clamped); a clamped B-spline of order ``k`` with
``N_knots = N_basis + k`` knots has ``N_basis`` basis functions, and
``p(t) = sum_i pcof[i] B_i(t / tf)``, q from the second half of pcof.

The time-derivative tables are Taylor-mode differentiation of the value
recurrence (``bsplvb``), written out: every quantity of the recurrence
is carried as its truncated Taylor series in ``t``. This is exact, as
the spline is a polynomial on each knot interval and the interval index
is piecewise constant. ``x = t / tf`` is linear in ``t``, so each
recurrence product has one linear factor, and every denominator
(``deltar + deltal``) is constant in ``t``. The native ``bsplvd``
(``qgd_tpu_torch.native``) is an independent check of these tables.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .base import Control


def clamped_uniform_knots(order: int, n_distinct: int) -> np.ndarray:
    """Padded knot vector on [0, 1]: uniform distinct knots with the ends
    repeated ``order - 1`` extra times."""
    distinct = np.linspace(0.0, 1.0, n_distinct)
    return np.concatenate([
        np.full(order - 1, distinct[0]), distinct,
        np.full(order - 1, distinct[-1]),
    ])


def _times_linear(c0, c1, series):
    """``(c0 + c1 h) * series`` truncated to the series' length; ``series``
    ``(..., m)`` holds Taylor coefficients in ``h``, ``c0`` is ``(...)``
    and ``c1`` a number."""
    out = c0[..., None] * series
    if series.shape[-1] > 1:
        out = torch.cat([out[..., :1], out[..., 1:] + c1 * series[..., :-1]],
                        dim=-1)
    return out


def _deboor_series(knots: torch.Tensor, order: int, x, left, m: int,
                   dx: float) -> torch.Tensor:
    """The ``bsplvb`` recurrence on truncated Taylor series: ``(...,
    order, m)``, the first ``m`` Taylor coefficients in ``h`` of the
    ``order`` non-vanishing splines along ``x + dx h``."""
    one = torch.zeros(x.shape + (m,), dtype=torch.float64, device=x.device)
    one[..., 0] = 1.0
    biatx = [one]
    deltal, deltar = [], []
    for j in range(1, order):
        deltar.append(knots[left + j] - x)
        deltal.append(x - knots[left + 1 - j])
        saved = torch.zeros_like(one)
        new = []
        for i in range(j):
            denom = deltar[i] + deltal[j - 1 - i]
            term = biatx[i] / denom[..., None]
            new.append(saved + _times_linear(deltar[i], -dx, term))
            saved = _times_linear(deltal[j - 1 - i], dx, term)
        new.append(saved)
        biatx = new
    return torch.stack(biatx, dim=-2)


def deboor_nonzero_values(knots, order: int, x, left) -> torch.Tensor:
    """Values at ``x`` (a tensor, ``left`` of its shape) of the ``order``
    B-splines of order ``order`` that do not vanish on the knot interval
    ``(knots[left], knots[left+1])``: the ``bsplvb`` recurrence. Returns
    ``(..., order)``; entry ``j`` is spline ``left - order + 1 + j``."""
    x = torch.as_tensor(x, dtype=torch.float64)
    knots = torch.as_tensor(knots, dtype=torch.float64, device=x.device)
    left = torch.as_tensor(left, device=x.device)
    return _deboor_series(knots, order, x, left, 1, 0.0)[..., 0]


@dataclass(frozen=True, eq=False)
class _DeBoorBSpline(Control):
    """Clamped uniform B-spline on the scaled domain [0, 1]."""
    knot_vector: np.ndarray
    degree: int
    N_basis_functions: int
    N_distinct_knots: int

    @property
    def bspline_order(self) -> int:
        return self.degree + 1

    def _table(self, ts, coeffs, m: int):
        """``(..., T, m)`` scaled derivatives for ``coeffs (...,
        N_basis)``."""
        order = self.bspline_order
        nd = self.N_distinct_knots
        knots = torch.as_tensor(self.knot_vector, dtype=torch.float64,
                                device=ts.device)
        x = ts / self.tf
        # distinct-interval index, clamped
        l_dist = torch.clamp(torch.floor(x * (nd - 1)).to(torch.int64), 0,
                             nd - 2)
        vals = _deboor_series(knots, order, x, self.degree + l_dist, m,
                              1.0 / self.tf)
        taps = coeffs[..., l_dist[:, None]
                      + torch.arange(order, device=ts.device)]
        return torch.einsum("...ti,tim->...tm", taps, vals)

    def p_derivatives(self, ts, pcof, m: int):
        return self._table(ts, pcof[..., :self.N_basis_functions], m)

    def q_derivatives(self, ts, pcof, m: int):
        return self._table(ts, pcof[..., self.N_basis_functions:], m)


def FortranBSplineControl(degree, N_basis_functions, tf):
    """Arbitrary-degree clamped B-spline control with ``N_basis_functions``
    basis functions per quadrature (``N_coeff = 2 * N_basis_functions``,
    pcof = [p-coeffs; q-coeffs])."""
    degree = int(degree)
    N_basis_functions = int(N_basis_functions)
    order = degree + 1
    n_knots = N_basis_functions + order
    n_distinct = n_knots - 2 * (order - 1)
    if n_distinct < 2:
        raise ValueError("Too few basis functions for this degree.")
    return _DeBoorBSpline(
        N_coeff=2 * N_basis_functions, tf=float(tf),
        knot_vector=clamped_uniform_knots(order, n_distinct), degree=degree,
        N_basis_functions=N_basis_functions, N_distinct_knots=n_distinct)


def GeneralBSplineControl(degree, N_knots, tf):
    """Arbitrary-degree B-spline over ``N_knots`` uniform distinct knots on
    [0, tf]: ``N_basis = degree + N_knots - 1`` per quadrature."""
    degree = int(degree)
    n_distinct = int(N_knots)
    order = degree + 1
    n_basis = order + n_distinct - 2
    return _DeBoorBSpline(
        N_coeff=2 * n_basis, tf=float(tf),
        knot_vector=clamped_uniform_knots(order, n_distinct), degree=degree,
        N_basis_functions=n_basis, N_distinct_knots=n_distinct)
