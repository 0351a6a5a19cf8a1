"""Problem and gate builders (numpy, setup time): copies of the
``qgd_tpu.models.builders`` functions, returning the port's
:class:`~qgd_tpu_torch.problem.SchrodingerProblem`.

They are copied rather than imported because importing anything under
``qgd_tpu`` imports JAX. The arithmetic is line for line the same, so the
arrays agree exactly (tests/test_torch_problem.py).
"""

from __future__ import annotations

import itertools

import numpy as np

from ..problem import (
    SchrodingerProblem,
    schrodinger_problem,
    schrodinger_problem_complex,
)


def lowering_operator_subsystem(subsystem_size: int) -> np.ndarray:
    """``a`` for one subsystem: ``sqrt(diag(1..n-1, k=1))``."""
    return np.sqrt(np.diag(np.arange(1, subsystem_size, dtype=np.float64),
                           k=1))


def lowering_operator(subsystem_size: int) -> np.ndarray:
    """The single-subsystem lowering operator under the name
    ``rotating_frame_qubit`` uses (the reference exports the name without
    defining it)."""
    return lowering_operator_subsystem(subsystem_size)


def lowering_operators_system(subsystem_sizes) -> list[np.ndarray]:
    """Per-subsystem lowering operators kron-lifted to the full system,
    bitstring ordering (first subsystem = leftmost ket factor)."""
    mats = []
    eyes = [np.eye(n) for n in subsystem_sizes]
    for i in range(len(subsystem_sizes)):
        factors = list(eyes)
        factors[i] = lowering_operator_subsystem(subsystem_sizes[i])
        out = factors[0]
        for f in factors[1:]:
            out = np.kron(out, f)
        mats.append(out)
    return mats


def basis_state(subsystem_sizes, subsystem_indices,
                bitstring_ordered: bool = True) -> np.ndarray:
    """Composite-system basis ket with 0-based per-subsystem indices."""
    subsystem_indices = list(subsystem_indices)
    if any(i >= n for i, n in zip(subsystem_indices, subsystem_sizes)):
        raise ValueError(
            f"Subsystem indices {subsystem_indices} are invalid for "
            f"subsystem sizes {tuple(subsystem_sizes)}.")
    vec = np.ones((1,))
    if bitstring_ordered:
        it = zip(subsystem_sizes, subsystem_indices)
    else:
        it = zip(reversed(subsystem_sizes), reversed(subsystem_indices))
    for n, i in it:
        e = np.zeros(n)
        e[i] = 1.0
        vec = np.kron(vec, e)
    return vec


def _essential_iter(essential_subsystem_sizes):
    """Essential-state index tuples, first subsystem varying slowest."""
    return itertools.product(*[range(n) for n in essential_subsystem_sizes])


def create_initial_conditions(subsystem_sizes, essential_subsystem_sizes,
                              bitstring_ordered: bool = True) -> np.ndarray:
    """Complex (N_tot, N_ess) matrix of the essential basis states in gate
    order."""
    cols = [basis_state(subsystem_sizes, idx, bitstring_ordered)
            for idx in _essential_iter(essential_subsystem_sizes)]
    return np.stack(cols, axis=1).astype(np.complex128)


def guard_projector(subsystem_sizes, essential_subsystem_sizes,
                    bitstring_ordered: bool = True) -> np.ndarray:
    """Real (2N, 2N) projector ``[[G, 0], [0, G]]`` onto the guard levels:
    a state is guarded iff any subsystem's level index reaches that
    subsystem's essential size."""
    n_tot = int(np.prod(subsystem_sizes))
    G = np.zeros((n_tot, n_tot))
    for idx in itertools.product(*[range(n) for n in subsystem_sizes]):
        if all(i < e for i, e in zip(idx, essential_subsystem_sizes)):
            continue
        v = basis_state(subsystem_sizes, idx, bitstring_ordered)
        G += np.outer(v, v)
    Z = np.zeros_like(G)
    return np.block([[G, Z], [Z, G]])


def create_gate(subsystem_sizes, essential_subsystem_sizes,
                initial_final_pairs, bitstring_ordered: bool = True
                ) -> np.ndarray:
    """Identity on the essential subspace with the columns named by
    ``initial_final_pairs`` overwritten."""
    G = create_initial_conditions(subsystem_sizes, essential_subsystem_sizes,
                                  bitstring_ordered)
    ordered = list(_essential_iter(essential_subsystem_sizes))
    for initial, final in initial_final_pairs:
        i = ordered.index(tuple(initial))
        G[:, i] = basis_state(subsystem_sizes, final, bitstring_ordered)
    return G


def rotation_matrix(subsystem_sizes, rotation_frequencies, t):
    """Per-subsystem frame-rotation matrices
    ``kron-lift(diag(exp(i w_i t n)))``."""
    mats = []
    eyes = [np.eye(n, dtype=np.complex128) for n in subsystem_sizes]
    for i, n in enumerate(subsystem_sizes):
        factors = list(eyes)
        factors[i] = np.diag(
            np.exp(1j * rotation_frequencies[i] * t * np.arange(n)))
        out = factors[0]
        for f in factors[1:]:
            out = np.kron(out, f)
        mats.append(out)
    return mats


def multi_qudit_hamiltonian_dispersive(subsystem_sizes, transition_freqs,
                                       rotation_freqs, kerr_coeffs
                                       ) -> np.ndarray:
    """Dispersive drift ``sum_q (w_q - w_rot) a'a - xi_q/2 a'a'aa -
    sum_{p>q} xi_pq a'_p a_p a'_q a_q``."""
    kerr = np.asarray(kerr_coeffs, dtype=np.float64)
    if not (kerr.shape[0] == kerr.shape[1] == len(transition_freqs)):
        raise ValueError("kerr_coeffs must be square, one row per subsystem")
    if not np.allclose(kerr, kerr.T):
        raise ValueError("kerr_coeffs must be symmetric")
    n_tot = int(np.prod(subsystem_sizes))
    H = np.zeros((n_tot, n_tot), dtype=np.complex128)
    a_ops = lowering_operators_system(subsystem_sizes)
    Q = len(subsystem_sizes)
    for q in range(Q):
        a_q = a_ops[q]
        num_q = a_q.conj().T @ a_q
        H += (transition_freqs[q] - rotation_freqs[q]) * num_q
        H -= 0.5 * kerr[q, q] * (a_q.conj().T @ a_q.conj().T @ a_q @ a_q)
        for p in range(q + 1, Q):
            a_p = a_ops[p]
            H -= kerr[p, q] * (a_p.conj().T @ a_p @ num_q)
    return H


def multi_qudit_hamiltonian_jayne(subsystem_sizes, transition_freqs,
                                  rotation_freq, kerr_coeffs,
                                  jayne_cummings_coeffs) -> np.ndarray:
    """Dispersive drift plus the Jaynes-Cummings couplings ``sum_{p>q}
    J_pq (a'_q a_p + a_q a'_p)``, with one common rotation frequency so
    the drift stays time-independent."""
    kerr = np.asarray(kerr_coeffs, dtype=np.float64)
    jc = np.asarray(jayne_cummings_coeffs, dtype=np.float64)
    if not np.allclose(kerr, kerr.T):
        raise ValueError("kerr_coeffs must be symmetric")
    if not np.allclose(jc, jc.T):
        raise ValueError("jayne_cummings_coeffs must be symmetric")
    if not np.allclose(np.diag(jc), 0.0):
        raise ValueError("jayne_cummings_coeffs must have a zero diagonal")
    H = multi_qudit_hamiltonian_dispersive(
        subsystem_sizes, transition_freqs,
        [rotation_freq] * len(subsystem_sizes), kerr).astype(np.complex128)
    a_ops = lowering_operators_system(subsystem_sizes)
    Q = len(subsystem_sizes)
    for q in range(Q):
        for p in range(q + 1, Q):
            a_q, a_p = a_ops[q], a_ops[p]
            H += jc[p, q] * (a_q.conj().T @ a_p + a_q @ a_p.conj().T)
    return H


def control_ops(subsystem_sizes):
    """Per-subsystem control operator pairs ``(a + a', a - a')``."""
    a_ops = lowering_operators_system(subsystem_sizes)
    sym_ops = [a + a.conj().T for a in a_ops]
    asym_ops = [a - a.conj().T for a in a_ops]
    return [np.real(s) for s in sym_ops], [np.real(s) for s in asym_ops]


def DispersiveProblem(subsystem_sizes, essential_subsystem_sizes,
                      transition_freqs, rotation_freqs, kerr_coeffs,
                      tf, nsteps, **kwargs) -> SchrodingerProblem:
    """Multi-qudit dispersive gate-design problem with guard projector and
    essential-basis initial conditions. ``kwargs`` go to
    :func:`~qgd_tpu_torch.problem.schrodinger_problem` (``solver``,
    ``schulz_iters``, ``schulz_warm_budget``, ``dtype``, ``device``)."""
    H = multi_qudit_hamiltonian_dispersive(
        subsystem_sizes, transition_freqs, rotation_freqs, kerr_coeffs)
    sym_ops, asym_ops = control_ops(subsystem_sizes)
    W = guard_projector(subsystem_sizes, essential_subsystem_sizes)
    U0 = create_initial_conditions(subsystem_sizes, essential_subsystem_sizes)
    n_ess = int(np.prod(essential_subsystem_sizes))
    return schrodinger_problem_complex(
        H, sym_ops, asym_ops, U0, tf, nsteps, n_ess, W, **kwargs)


def JaynesCummingsProblem(subsystem_sizes, essential_subsystem_sizes,
                          transition_freqs, rotation_freq, kerr_coeffs,
                          jayne_cummings_coeffs, tf, nsteps,
                          **kwargs) -> SchrodingerProblem:
    """Jaynes-Cummings gate-design problem. The reference's version passes
    undefined initial conditions; as in the JAX package, the essential
    basis states are used, as :func:`DispersiveProblem` does. ``kwargs``
    as for :func:`DispersiveProblem`."""
    H = multi_qudit_hamiltonian_jayne(
        subsystem_sizes, transition_freqs, rotation_freq, kerr_coeffs,
        jayne_cummings_coeffs)
    sym_ops, asym_ops = control_ops(subsystem_sizes)
    W = guard_projector(subsystem_sizes, essential_subsystem_sizes)
    U0 = create_initial_conditions(subsystem_sizes, essential_subsystem_sizes)
    n_ess = int(np.prod(essential_subsystem_sizes))
    return schrodinger_problem_complex(
        H, sym_ops, asym_ops, U0, tf, nsteps, n_ess, W, **kwargs)


def construct_rabi_prob(tf=np.pi, nsteps=100, **kwargs) -> SchrodingerProblem:
    """2-level Rabi oscillator, zero drift, one control pair; for duration
    ``pi`` an amplitude |Omega| = 0.5 pulse is a SWAP gate. ``kwargs`` as
    for :func:`DispersiveProblem` (the problem is on the card unless
    ``device="cpu"``)."""
    a = np.array([[0.0, 1.0], [0.0, 0.0]])
    H = np.zeros((2, 2), dtype=np.complex128)
    return schrodinger_problem_complex(
        H, [a + a.T], [a - a.T], np.eye(2, dtype=np.complex128),
        tf, nsteps, 2, **kwargs)


def _rand_sym(rng, n):
    m = rng.random((n, n))
    return m + m.T


def _rand_asym(rng, n):
    m = rng.random((n, n))
    return m - m.T


def construct_rand_prob(complex_system_size, N_operators, tf=2.0, nsteps=100,
                        seed: int = 0, **kwargs) -> SchrodingerProblem:
    """Seeded random problem: one numpy PCG64 stream seeded by ``seed``
    draws the initial states, the drift and the control operators, in the
    JAX package's order, so both packages build the same arrays."""
    n = int(complex_system_size)
    rng = np.random.default_rng(seed)
    re = rng.random((n, n))
    im = rng.random((n, n))
    U0 = re + 1j * im
    H = _rand_sym(rng, n) + 1j * _rand_asym(rng, n)
    sym_ops = [_rand_sym(rng, n) for _ in range(N_operators)]
    asym_ops = [_rand_asym(rng, n) for _ in range(N_operators)]
    return schrodinger_problem_complex(
        H, sym_ops, asym_ops, U0, tf, nsteps, n, **kwargs)


def dahlquist_problem(lam, initial_condition=1.0, with_control: bool = False,
                      tf=1.0, nsteps=10, **kwargs) -> SchrodingerProblem:
    """1x1 problem ``y' = lambda y`` with purely imaginary ``lambda``.
    ``kwargs`` as for :func:`DispersiveProblem`."""
    lam = complex(lam)
    H = 1j * lam  # hermitian iff lam purely imaginary
    if abs(H.imag) > 1e-14:
        raise ValueError("lambda must be purely imaginary for a Hermitian H")
    u0 = np.array([[np.real(initial_condition)]])
    v0 = np.array([[np.imag(initial_condition)]])
    if with_control:
        sym_ops, asym_ops = [np.ones((1, 1))], [np.zeros((1, 1))]
    else:
        sym_ops, asym_ops = [], []
    return schrodinger_problem(
        np.array([[H.real]]), np.array([[0.0]]), sym_ops, asym_ops,
        u0, v0, tf, nsteps, 1, **kwargs)


def rotating_frame_qubit(N_ess_levels, N_guard_levels, tf=1.0, nsteps=10,
                         detuning_frequency=1.0, self_kerr_coefficient=1.0,
                         **kwargs) -> SchrodingerProblem:
    """One qudit in the rotating frame with detuning and self-Kerr, one
    control pair, the essential basis states as initial conditions.
    ``kwargs`` as for :func:`DispersiveProblem`."""
    n_tot = N_ess_levels + N_guard_levels
    a = lowering_operator_subsystem(n_tot)
    num = a.T @ a
    K = (2 * np.pi * detuning_frequency) * num \
        - (0.5 * 2 * np.pi * self_kerr_coefficient) * (a.T @ a.T @ a @ a)
    u0 = np.zeros((n_tot, N_ess_levels))
    v0 = np.zeros((n_tot, N_ess_levels))
    for i in range(N_ess_levels):
        u0[i, i] = 1.0
    return schrodinger_problem(
        K, np.zeros_like(K), [a + a.T], [a - a.T], u0, v0, tf, nsteps,
        N_ess_levels, **kwargs)


_CNOT3_FREQS_GHZ = (4.10336, 4.81831, 7.8447)


def cnot3_problem(tf=550.0, nsteps=5500, **kwargs) -> SchrodingerProblem:
    """The CNOT3 benchmark system: 3 coupled transmons, subsystem sizes
    (4,4,4), essential (2,2,2), dispersive drift with guard levels
    (transitions 2pi*(4.10336, 4.81831, 7.8447) GHz rotating at their own
    frequencies, self-Kerr 2pi*(0.2198, 0.2252, 0.001), cross-Kerr
    2pi*(0.01, 0.001, 0.001))."""
    freqs = 2 * np.pi * np.array(_CNOT3_FREQS_GHZ)
    xi = 2 * np.pi * np.array([0.2198, 0.2252, 0.001])
    xi12, xi13, xi23 = 2 * np.pi * np.array([0.01, 0.001, 0.001])
    kerr = np.array([
        [xi[0], xi12, xi13],
        [xi12, xi[1], xi23],
        [xi13, xi23, xi[2]],
    ])
    return DispersiveProblem(
        (4, 4, 4), (2, 2, 2), freqs, freqs, kerr, tf, nsteps, **kwargs)


def cnot3_carrier_frequencies():
    """Carrier frequencies (rad/ns) for the CNOT3 controls, one row per
    oscillator: ``[0, -chi_qp, -chi_qr]``, the cross-Kerr shifts of each
    oscillator's 0<->1 transition conditioned on the other two. With
    ``BSpline2Control(10)`` envelopes: 3 freqs x 10 splines x 2 quadratures
    x 3 oscillators = 180 parameters."""
    x12, x13, x23 = 2 * np.pi * np.array([0.01, 0.001, 0.001])
    return [
        [0.0, -x12, -x13],
        [0.0, -x12, -x23],
        [0.0, -x13, -x23],
    ]


def cnot3_target(tf=550.0, rotating_frame=True) -> np.ndarray:
    """The CNOT3 target: CNOT on qudits (1,2), identity on the spectator,
    transformed into the frame rotating at the transition frequencies
    (``rotating_frame=False`` gives the bare lab-frame gate)."""
    pairs = []
    for k in range(2):
        pairs.append(((1, 1, k), (1, 0, k)))
        pairs.append(((1, 0, k), (1, 1, k)))
    target = create_gate((4, 4, 4), (2, 2, 2), pairs)
    if rotating_frame:
        rots = rotation_matrix(
            (4, 4, 4), 2 * np.pi * np.array(_CNOT3_FREQS_GHZ), tf)
        target = rots[0] @ rots[1] @ rots[2] @ target
    return target


def cnot2_problem(tf=100.0, nsteps=2000, **kwargs) -> SchrodingerProblem:
    """The CNOT2 benchmark: 2 transmons (2,2) dispersive, self-Kerr
    2pi*(0.2198, 0.2252), cross-Kerr 2pi*0.01, tf = 100."""
    freqs = 2 * np.pi * np.array([4.10336, 4.81831])
    xi = 2 * np.pi * np.array([0.2198, 0.2252])
    x12 = 2 * np.pi * 0.01
    kerr = np.array([[xi[0], x12], [x12, xi[1]]])
    return DispersiveProblem(
        (2, 2), (2, 2), freqs, freqs, kerr, tf, nsteps, **kwargs)
