"""Plain reference of the objective and its gradient: the Hermite
(two-point Taylor) discretisation of the Schrodinger equation, propagated
step by step with dense inverses of the implicit stages, and the gradient
by autograd through it. It imports nothing of the program under test and takes only the
arrays of :func:`qgdbench.system.build_inputs` and the control vectors.

For the state ``w = [Re psi; Im psi]`` (2N x N_ess) and ``H(t) = H0 + sum_j
p_j(t) (a_j + a_j') + i q_j(t) (a_j - a_j')``, ``dw/dt = A(t) w`` with
``A = [[S, K], [-K, S]]``, ``K = Re H``, ``S = Im H``. The order-2m step
is

    sum_j (-dt)^j c_j D_j(t_{n+1}) w_{n+1} = sum_j dt^j c_j D_j(t_n) w_n,

``c_j = m! (2m-j)! / ((2m)! (m-j)!)``, where ``D_j(t) w`` are the scaled
derivatives ``w^(j)/j!``: ``D_0 w = w``, ``D_{j+1} w = (sum_{i<=j}
A_{j-i} D_i w) / (j+1)`` with ``A_k = A^(k)/k!``, whose control parts are
the scaled Taylor coefficients of the pulses. A pulse is a sum over
carrier frequencies ``w_f`` of a complex envelope times ``exp(i w_f t)``;
the envelope's real and imaginary parts are quadratic B-splines of D1
coefficients each (uniform knots ``tf / (D1 - 2)`` apart; at a knot the
piece on the left holds). The objective of one control vector is

    1 - |<target, psi_T>|^2 / N_ess^2                     (infidelity)
    + dt / tf * trapezoid_n <w_n, W w_n>                    (guard)
    + ridge * |pcof|^2 / N_params                            (ridge)

``precision="float64"`` is the reference. ``precision="tf32"`` is the
control: the same arithmetic in float32 with every matrix product's
operands rounded to TF32 (10 mantissa bits, to nearest) and summed in
float32, as the tensor cores do, the gradient's products as well.

``solve`` picks how a step applies its implicit stage: ``"inverse"``
inverts a block's stage matrices together and multiplies each step's
right-hand side by its inverse (a product, so TF32 in the control);
``"lu"`` solves each step by a float32 (or float64) LU factorisation,
the products around it in the precision above. The control's default is
``"lu"``: TF32 stage products with a float32 solve are what a program
that moved its stage build to the tensor cores would compute.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

# steps whose intermediates are recomputed together in the backward pass:
# bounds the memory autograd holds to one block's
_BLOCK = 50


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: the low 13 mantissa bits cleared,
    to nearest, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class _RoundIn(torch.autograd.Function):
    """TF32 rounding of a product's operand; the gradient passes as is."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """Identity whose gradient is rounded to TF32: the products of the
    backward pass get TF32 operands too."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def hermite_weights(m: int) -> list:
    """``c_j`` for ``j = 0..m``."""
    f = math.factorial
    return [f(m) * f(2 * m - j) / (f(2 * m) * f(m - j)) for j in range(m + 1)]


def _spline_derivatives(ts: np.ndarray, D1: int, tf: float, m: int):
    """``(m, T, D1)``: ``B_k^(d)(t) / d!`` for ``d < m`` at the times
    ``ts``, of the D1 quadratic B-splines of width 3 knot intervals,
    spline k centred at ``(k - 1/2) * knot``."""
    knot = tf / (D1 - 2)
    width = 3.0 * knot
    interval = np.clip(np.ceil(ts / knot), 1, D1 - 2)       # (T,)
    out = np.zeros((m, ts.shape[0], D1))
    for k in range(D1):
        tau = (ts - knot * (k - 0.5)) / width
        piece = interval + 1 - k          # 0 rising, 1 middle, 2 falling
        polys = {0: ((9 / 8, 4.5, 4.5)), 1: (0.75, 0.0, -9.0),
                 2: (9 / 8, -4.5, 4.5)}
        for p, (c0, c1, c2) in polys.items():
            on = piece == p
            vals = (c0 + c1 * tau + c2 * tau ** 2,
                    (c1 + 2 * c2 * tau) / width,
                    np.full_like(tau, 2 * c2 / width ** 2) / 2.0)
            for d in range(min(m, 3)):
                out[d, on, k] = vals[d][on]
    return out


def pulse_basis(inputs: dict, ts: np.ndarray, m: int) -> np.ndarray:
    """``(N_ops, T, m, P)`` complex: the scaled Taylor coefficient ``k``
    of qudit j's pulse ``p_j + i q_j`` at each time, per unit of each of
    that qudit's P = F * 2 * D1 parameters (frequency-major, then the
    real part's D1 spline coefficients, then the imaginary part's)."""
    D1, freqs = inputs["D1"], inputs["carrier_freqs"]
    B = _spline_derivatives(ts, D1, inputs["tf"], m)       # (m, T, D1)
    n_ops, F = freqs.shape
    out = np.zeros((n_ops, ts.shape[0], m, F * 2 * D1), dtype=complex)
    for j in range(n_ops):
        for f in range(F):
            w = freqs[j, f]
            wave = np.exp(1j * w * ts)
            for k in range(m):
                # (e exp(iwt))^(k)/k! = sum_d e^(d)/d! (iw)^(k-d)/(k-d)!
                term = sum(B[d] * ((1j * w) ** (k - d)
                                   / math.factorial(k - d))
                           for d in range(k + 1)) * wave[:, None]
                base = f * 2 * D1
                out[j, :, k, base:base + D1] = term
                out[j, :, k, base + D1:base + 2 * D1] = 1j * term
    return out


class Reference:
    """The objective parts and gradient of ``config``'s problem at
    ``nsteps`` steps for batches of control vectors (module docstring).

    ``inputs`` are :func:`qgdbench.system.build_inputs`'s arrays."""

    def __init__(self, inputs: dict, order: int, nsteps: int, ridge: float,
                 device, precision: str = "float64", solve=None):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.solve = solve or ("lu" if self.tf32 else "inverse")
        if self.solve not in ("inverse", "lu"):
            raise ValueError(f"solve {solve!r}")
        self.dtype = torch.float32 if self.tf32 else torch.float64
        self.m, self.T, self.ridge = order // 2, int(nsteps), float(ridge)
        self.device = torch.device(device)
        self.dt = inputs["tf"] / self.T
        self.tf = inputs["tf"]
        self.N_ess = inputs["N_ess"]
        H0 = inputs["H0"]
        n_ops = inputs["sym_ops"].shape[0]
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                      device=self.device)
        self.N = H0.shape[0]
        self.K0, self.S0 = t(H0.real), t(H0.imag)
        self.sym = t(inputs["sym_ops"].reshape(n_ops, -1))
        self.asym = t(inputs["asym_ops"].reshape(n_ops, -1))
        self.w0 = t(np.concatenate([inputs["u0"], 0 * inputs["u0"]]))
        self.W = t(inputs["guard"])
        tgt = inputs["target"]
        self.tgt_re, self.tgt_im = t(tgt.real), t(tgt.imag)
        ts = np.arange(self.T + 1, dtype=np.float64) * self.dt
        G = pulse_basis(inputs, ts, self.m)         # (N_ops, T+1, m, P)
        self.n_ops, self.P = n_ops, G.shape[-1]
        # (N_ops, P, (T+1) m) for one product per qudit
        flat = lambda a: t(np.ascontiguousarray(
            a.reshape(n_ops, -1, self.P).transpose(0, 2, 1)))
        self.G_re, self.G_im = flat(G.real), flat(G.imag)
        self.eye = torch.eye(2 * self.N, dtype=self.dtype, device=self.device)
        c = hermite_weights(self.m)
        self.w_rhs = [c[j] * self.dt ** j for j in range(self.m + 1)]
        self.w_lhs = [c[j] * (-self.dt) ** j for j in range(self.m + 1)]

    def _mm(self, a, b):
        if self.tf32:
            return _RoundGrad.apply(_RoundIn.apply(a) @ _RoundIn.apply(b))
        return a @ b

    def _tables(self, pcof):
        """``(P, Q)`` ``(k, T+1, m, N_ops)``: the pulses' scaled Taylor
        coefficients (real and imaginary parts) for ``pcof (k, N_params)``."""
        k = pcof.shape[0]
        x = pcof.reshape(k, self.n_ops, self.P).transpose(0, 1)  # (ops,k,P)
        shape = (self.n_ops, k, self.T + 1, self.m)
        P = self._mm(x, self.G_re).reshape(shape).permute(1, 2, 3, 0)
        Q = self._mm(x, self.G_im).reshape(shape).permute(1, 2, 3, 0)
        return P, Q

    def _generator(self, p, q):
        """``(..., m, 2N, 2N)`` scaled generator derivatives from the tables
        ``p, q (..., m, N_ops)`` of their times."""
        N, shape = self.N, p.shape[:-1] + (self.N, self.N)
        K = self._mm(p.reshape(-1, self.n_ops), self.sym).reshape(shape)
        S = self._mm(q.reshape(-1, self.n_ops), self.asym).reshape(shape)
        drift = torch.zeros(self.m, 1, 1, dtype=self.dtype,
                            device=self.device)
        drift[0] = 1.0
        K = K + drift * self.K0
        S = S + drift * self.S0
        return torch.cat([torch.cat([S, K], -1), torch.cat([-K, S], -1)], -2)

    def _derivs(self, A, X0):
        """``[D_0 X0, ..., D_m X0]`` for the generator stack ``A (..., m,
        2N, 2N)``; ``X0 = None`` stands for the identity."""
        out = [X0]
        for j in range(self.m):
            acc = A[..., j, :, :] if X0 is None else self._mm(A[..., j, :, :],
                                                              X0)
            for i in range(1, j + 1):
                acc = acc + self._mm(A[..., j - i, :, :], out[i])
            out.append(acc / (j + 1))
        return out

    def _block(self, w, p, q):
        """Steps over the tables ``p, q (k, L+1, m, N_ops)`` from ``w``:
        ``(w after the L steps, sum of <w_n, W w_n> over the L new
        states)``. The L implicit-stage matrices are formed together, and
        inverted together or factorised step by step (``solve``)."""
        A = self._generator(p, q)                    # (k, L+1, m, 2N, 2N)
        DI = self._derivs(A[:, 1:], None)
        lhs = self.w_lhs[0] * self.eye + sum(
            c * d for c, d in zip(self.w_lhs[1:], DI[1:]))
        if self.solve == "inverse":
            lhs = torch.linalg.inv(lhs)              # (k, L, 2N, 2N)
        guard = torch.zeros(w.shape[0], dtype=self.dtype, device=self.device)
        for i in range(p.shape[1] - 1):
            Dw = self._derivs(A[:, i], w)
            rhs = sum(c * d for c, d in zip(self.w_rhs, Dw))
            if self.solve == "inverse":
                w = self._mm(lhs[:, i], rhs)
            else:
                w = torch.linalg.solve(lhs[:, i], rhs)
            guard = guard + self._guard_density(w)
        return w, guard

    def _guard_density(self, w):
        return torch.sum(w * self._mm(self.W, w), dim=(-2, -1))

    def _objective(self, pcof):
        """``(infidelity, guard, ridge)``, each ``(k,)``."""
        P, Q = self._tables(pcof)
        w = self.w0.expand(pcof.shape[0], -1, -1)
        g0 = self._guard_density(w)
        guard = 0.5 * g0
        for a in range(0, self.T, _BLOCK):
            b = min(a + _BLOCK, self.T)
            w, g = checkpoint(self._block, w, P[:, a:b + 1], Q[:, a:b + 1],
                              use_reentrant=False)
            guard = guard + g
        guard = (guard - 0.5 * self._guard_density(w)) * (self.dt / self.tf)
        N = self.N
        u, v = w[:, :N], w[:, N:]
        # <target, psi> = sum conj(target) psi
        ov_re = torch.sum(self.tgt_re * u + self.tgt_im * v, dim=(-2, -1))
        ov_im = torch.sum(self.tgt_re * v - self.tgt_im * u, dim=(-2, -1))
        infid = 1.0 - (ov_re ** 2 + ov_im ** 2) / self.N_ess ** 2
        ridge = self.ridge * torch.sum(pcof * pcof, dim=-1) / pcof.shape[-1]
        return infid, guard, ridge

    def evaluate(self, pcof) -> dict:
        """``{"infidelity", "guard", "ridge" (k,), "grad" (k, N_params)}``
        as float64 numpy for the control vectors ``pcof (k, N_params)``."""
        tf32_before = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.enable_grad():
                x = torch.as_tensor(pcof).detach().to(
                    self.device, self.dtype).clone().requires_grad_(True)
                infid, guard, ridge = self._objective(x)
                (grad,) = torch.autograd.grad((infid + guard + ridge).sum(),
                                              x)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32_before
        out = {"infidelity": infid, "guard": guard, "ridge": ridge,
               "grad": grad}
        return {k: v.detach().to(torch.float64).cpu().numpy()
                for k, v in out.items()}
