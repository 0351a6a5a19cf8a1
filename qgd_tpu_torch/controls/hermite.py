"""Piecewise-Hermite interpolant controls (counterpart of
``qgd_tpu.controls.hermite``: ``HermiteControl``,
``HermiteCarrierControl``, ``sample_from_controls`` and
``construct_pcof_from_sample``).

The pulse is the degree-(2m+1) Hermite interpolating polynomial of the
value and first ``m = N_derivatives`` derivatives at ``N_points`` evenly
spaced control points. pcof holds that (scaled) derivative data, ``(1+m)``
entries per point, p-half then q-half. Entry ``(i, n)`` times its scaling
factor is the normalized Taylor datum ``dt^i p^{(i)}(t_n)/i!``: factor 1
(``"Taylor"``), ``dt^i/i!`` (``"Derivative"``) or ``(i+1)! 2^i``
(``"Heuristic"``).

A constant matrix ``Hmat (2m+2, 2m+2)``, built at construction, maps the
normalized data at an interval's two ends to the scaled derivatives
``dt^k p^{(k)}(t_c)/k!`` at its midpoint; evaluation is a gather, one
product with ``Hmat`` and a Horner evaluation, over all times and control
vectors at once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .base import Control, as_control_tuple, control_vector_slice
from .carrier import CarrierControl


def hermite_interp_map(m: int, xc: float = 0.5) -> np.ndarray:
    """Matrix mapping two-point normalized Hermite data to scaled
    derivatives at ``xc`` (unit-interval coordinate). Input ordering:
    ``[p^{(j)}(0)/j! for j=0..m] ++ [p^{(j)}(1)/j! for j=0..m]``; output
    row ``k``: ``p^{(k)}(xc)/k!`` of the unique degree-(2m+1)
    interpolant."""
    n = 2 * m + 2
    # conditions on the monomial coefficients a_k of p(x) = sum a_k x^k:
    #   p^{(j)}(0)/j! = a_j,  p^{(j)}(1)/j! = sum_k C(k, j) a_k
    V = np.zeros((n, n))
    for j in range(m + 1):
        V[j, j] = 1.0
        for k in range(n):
            if k >= j:
                V[m + 1 + j, k] = math.comb(k, j)
    A = np.linalg.solve(V, np.eye(n))
    # recentre at xc: b_k = p^{(k)}(xc)/k! = sum_j C(j, k) a_j xc^(j-k)
    R = np.zeros((n, n))
    for k in range(n):
        for j in range(k, n):
            R[k, j] = math.comb(j, k) * xc ** (j - k)
    return R @ A


@dataclass(frozen=True, eq=False)
class _Hermite(Control):
    Hmat: np.ndarray            # (2m+2, 2m+2)
    scaling: np.ndarray         # (1+m,) per-derivative pcof scaling factors
    N_points: int
    N_derivatives: int

    @property
    def dt(self) -> float:
        return self.tf / (self.N_points - 1)

    def _table(self, ts, coeffs, m_out: int):
        """``(..., T, m_out)`` scaled derivatives ``p^{(k)}(t)/k! = dt^{-k}
        sum_j C(j, k) b_j tau^{j-k}`` for ``coeffs (..., N_points
        (1+m))``, ``b`` the midpoint coefficients of t's interval and
        ``tau = (t - t_c)/dt``."""
        nd1 = self.N_derivatives + 1
        dt = self.dt
        dev = ts.device
        i = torch.clamp(torch.floor(ts / dt).to(torch.int64), 0,
                        self.N_points - 2)
        data = coeffs.reshape(coeffs.shape[:-1] + (self.N_points, nd1))
        scaling = torch.as_tensor(self.scaling, dtype=torch.float64,
                                  device=dev)
        both = torch.cat([data[..., i, :] * scaling,
                          data[..., i + 1, :] * scaling], dim=-1)
        b = both @ torch.as_tensor(self.Hmat, dtype=torch.float64,
                                   device=dev).T          # (..., T, n)
        tau = (ts - (i.to(torch.float64) + 0.5) * dt) / dt
        n = b.shape[-1]
        out = []
        for k in range(m_out):
            if k >= n:
                out.append(torch.zeros_like(b[..., 0]))
                continue
            acc = b[..., n - 1] * math.comb(n - 1, k)
            for j in range(n - 2, k - 1, -1):
                acc = acc * tau + b[..., j] * math.comb(j, k)
            out.append(acc / dt ** k)
        return torch.stack(out, dim=-1)

    def p_derivatives(self, ts, pcof, m: int):
        return self._table(ts, pcof[..., :self.N_coeff // 2], m)

    def q_derivatives(self, ts, pcof, m: int):
        return self._table(ts, pcof[..., self.N_coeff // 2:], m)


def HermiteControl(N_points, tf, N_derivatives,
                   scaling_type: str = "Heuristic"):
    """Hermite-interpolant control with ``N_points`` control points and
    ``N_derivatives`` derivatives per point."""
    N_points = int(N_points)
    N_derivatives = int(N_derivatives)
    if N_points < 2:
        raise ValueError("N_points must be > 1")
    dt = float(tf) / (N_points - 1)
    if scaling_type == "Taylor":
        scaling = [1.0] * (N_derivatives + 1)
    elif scaling_type == "Derivative":
        scaling = [dt ** i / math.factorial(i)
                   for i in range(N_derivatives + 1)]
    elif scaling_type == "Heuristic":
        scaling = [math.factorial(i + 1) * 2.0 ** i
                   for i in range(N_derivatives + 1)]
    else:
        raise ValueError(f"Unknown scaling_type {scaling_type!r}")
    return _Hermite(
        N_coeff=2 * N_points * (N_derivatives + 1), tf=float(tf),
        Hmat=hermite_interp_map(N_derivatives),
        scaling=np.asarray(scaling, dtype=np.float64),
        N_points=N_points, N_derivatives=N_derivatives)


def HermiteCarrierControl(N_points, tf, N_derivatives, carrier_frequencies,
                          scaling_type: str = "Taylor"):
    """Hermite interpolants modulated by carrier waves:
    ``CarrierControl(HermiteControl(...))``, one Hermite parameter block
    per carrier frequency."""
    base = HermiteControl(N_points, tf, N_derivatives, scaling_type)
    return CarrierControl(base, carrier_frequencies)


def sample_from_controls(controls_orig, pcof_orig, N_samples, N_derivatives,
                         scaling_type: str = "Derivative"):
    """Hermite controls sampling an existing control set, one per original
    control: returns ``(controls_new, pcof_new)``, the pcofs
    concatenated."""
    controls_orig = as_control_tuple(controls_orig)
    pcof_orig = torch.as_tensor(pcof_orig, dtype=torch.float64)
    new_controls, new_pcofs = [], []
    for i, ctrl in enumerate(controls_orig):
        hc = HermiteControl(N_samples, ctrl.tf, N_derivatives, scaling_type)
        new_controls.append(hc)
        new_pcofs.append(construct_pcof_from_sample(
            ctrl, control_vector_slice(pcof_orig, controls_orig, i), hc))
    return new_controls, torch.cat(new_pcofs)


def construct_pcof_from_sample(control_orig, pcof_orig, hermite_control):
    """The Hermite pcof that reproduces ``control_orig``'s values and
    derivatives at the control points of ``hermite_control`` (a Hermite
    control, or a carrier-wrapped one): entry ``(j, n) = dt^j f^{(j)}(t_n)
    / (j! scaling_j)``."""
    inner = getattr(hermite_control, "base_control", hermite_control)
    nd1 = inner.N_derivatives + 1
    dt = inner.dt
    pcof = torch.as_tensor(pcof_orig, dtype=torch.float64)
    ts = torch.arange(inner.N_points, dtype=torch.float64,
                      device=pcof.device) * dt
    # the tables hold f^{(j)}/j!, so entry (j, n) is table * dt^j / scaling
    scale = torch.tensor([dt ** j / inner.scaling[j] for j in range(nd1)],
                         dtype=torch.float64, device=pcof.device)
    halves = [tab * scale for tab in
              control_orig.pq_derivatives(ts, pcof, nd1)]
    return torch.cat([h.reshape(-1) for h in halves])
