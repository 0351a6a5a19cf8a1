"""Problem and gate builders (numpy, setup time): copies of the
``qgd_tpu.models.builders`` functions the ported path needs, returning the
port's :class:`~qgd_tpu_torch.problem.SchrodingerProblem`.

They are copied rather than imported because importing anything under
``qgd_tpu`` imports JAX. The arithmetic is line for line the same, so the
arrays agree exactly (tests/test_torch_problem.py).
"""

from __future__ import annotations

import itertools

import numpy as np

from ..problem import SchrodingerProblem, schrodinger_problem_complex


def lowering_operator_subsystem(subsystem_size: int) -> np.ndarray:
    """``a`` for one subsystem: ``sqrt(diag(1..n-1, k=1))``."""
    return np.sqrt(np.diag(np.arange(1, subsystem_size, dtype=np.float64),
                           k=1))


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
