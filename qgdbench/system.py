"""The inputs both sides get: the coupled-transmon system of a
configuration file, built in numpy from its published constants.

A configuration's ``system`` names the subsystem sizes, the essential
sizes, the transition and rotation frequencies and the Kerr shifts
(GHz; multiplied by 2 pi here, so every rate is in rad/ns); its ``gate``
names the control and target qudits of a CNOT; its ``controls`` the
B-spline size and the carrier frequencies. :func:`build_inputs` returns
the arrays that the program under test and the plain reference both
take, so neither derives them from the other.

Conventions: kets are Kronecker products with the first subsystem as the
leftmost factor; the gate's columns are the essential states with the
first subsystem varying slowest. The Hamiltonian of the dispersive model
in the frame rotating at the rotation frequencies is

    H0 = sum_q (w_q - r_q) a_q' a_q - xi_qq / 2 a_q' a_q' a_q a_q
         - sum_{p>q} xi_pq a_p' a_p a_q' a_q

and the control Hamiltonian of qudit j is ``p_j(t) (a_j + a_j') + i
q_j(t) (a_j - a_j')``.
"""

from __future__ import annotations

import itertools

import numpy as np

TWO_PI = 2.0 * np.pi


def _lift(op: np.ndarray, q: int, sizes) -> np.ndarray:
    """``op`` acting on subsystem ``q`` of the composite system."""
    out = np.ones((1, 1))
    for i, n in enumerate(sizes):
        out = np.kron(out, op if i == q else np.eye(n))
    return out


def _lowering(sizes) -> list:
    """Each subsystem's lowering operator on the composite system."""
    return [_lift(np.diag(np.sqrt(np.arange(1.0, n)), 1), q, sizes)
            for q, n in enumerate(sizes)]


def _ket(sizes, levels) -> np.ndarray:
    out = np.ones(1)
    for n, k in zip(sizes, levels):
        e = np.zeros(n)
        e[k] = 1.0
        out = np.kron(out, e)
    return out


def _essential_states(ess_sizes):
    return list(itertools.product(*[range(n) for n in ess_sizes]))


def hamiltonian(system: dict) -> np.ndarray:
    """The drift ``H0`` (complex, N x N) of ``system``."""
    sizes = system["subsystem_sizes"]
    w = TWO_PI * np.asarray(system["transition_freqs_GHz"], dtype=float)
    r = TWO_PI * np.asarray(system["rotation_freqs_GHz"], dtype=float)
    kerr = TWO_PI * np.asarray(system["kerr_GHz"], dtype=float)
    N = int(np.prod(sizes))
    a = _lowering(sizes)
    H = np.zeros((N, N), dtype=complex)
    for q in range(len(sizes)):
        num = a[q].T @ a[q]
        H += (w[q] - r[q]) * num - 0.5 * kerr[q, q] * (a[q].T @ a[q].T
                                                       @ a[q] @ a[q])
        for p in range(q + 1, len(sizes)):
            H -= kerr[p, q] * (a[p].T @ a[p] @ num)
    return H


def cnot_target(system: dict, gate: dict, tf: float) -> np.ndarray:
    """The CNOT on the essential states (complex, N x N_ess): the target
    qudit's levels 0 and 1 swap where the control qudit sits at 1; in the
    rotating frame (``gate["rotating_frame"]``) it is multiplied by
    ``exp(i r_q t_f n_q)`` on every qudit."""
    sizes = system["subsystem_sizes"]
    ess = _essential_states(system["essential_sizes"])
    c, t = gate["control_qudit"], gate["target_qudit"]
    cols = []
    for levels in ess:
        out = list(levels)
        if levels[c] == 1:
            out[t] = 1 - levels[t]
        cols.append(_ket(sizes, out))
    G = np.stack(cols, axis=1).astype(complex)
    if gate.get("rotating_frame", False):
        r = TWO_PI * np.asarray(system["rotation_freqs_GHz"], dtype=float)
        phase = np.zeros(int(np.prod(sizes)))
        for idx in itertools.product(*[range(n) for n in sizes]):
            k = int(np.ravel_multi_index(idx, sizes))
            phase[k] = sum(r[q] * tf * idx[q] for q in range(len(sizes)))
        G = np.exp(1j * phase)[:, None] * G
    return G


def build_inputs(config: dict) -> dict:
    """Every array of ``config``'s problem, float64/complex128 numpy:
    ``H0``, ``sym_ops``/``asym_ops`` (N_ops, N, N) real, ``u0`` (N, N_ess)
    real, ``guard`` (2N, 2N) real (the projector onto the levels outside
    the essential ones, on both halves of the real-stacked state),
    ``target`` (N, N_ess) complex, ``carrier_freqs`` (N_ops, F) in rad/ns,
    and the scalars ``tf``, ``D1``, ``n_params`` (carriers x 2 x D1 per
    qudit), ``N_ess``."""
    system = config["system"]
    sizes, ess_sizes = system["subsystem_sizes"], system["essential_sizes"]
    tf = float(config["tf_ns"])
    a = _lowering(sizes)
    ess = _essential_states(ess_sizes)
    u0 = np.stack([_ket(sizes, levels) for levels in ess], axis=1)
    guarded = np.zeros(int(np.prod(sizes)))
    for idx in itertools.product(*[range(n) for n in sizes]):
        if any(i >= e for i, e in zip(idx, ess_sizes)):
            guarded[int(np.ravel_multi_index(idx, sizes))] = 1.0
    ctrl = config["controls"]
    return {
        "H0": hamiltonian(system),
        "sym_ops": np.stack([x + x.T for x in a]),
        "asym_ops": np.stack([x - x.T for x in a]),
        "u0": u0,
        "guard": np.diag(np.concatenate([guarded, guarded])),
        "target": cnot_target(system, config["gate"], tf),
        "carrier_freqs": TWO_PI * np.asarray(ctrl["carrier_freqs_GHz"],
                                             dtype=float),
        "tf": tf,
        "D1": int(ctrl["D1"]),
        "n_params": len(a) * len(ctrl["carrier_freqs_GHz"][0]) * 2
        * int(ctrl["D1"]),
        "N_ess": len(ess),
    }
