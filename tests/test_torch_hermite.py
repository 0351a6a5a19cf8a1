"""qgd_tpu_torch Hermite core (batched) against qgd_tpu.ops.hermite,
float64 at 1e-13."""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu.models as jm  # noqa: E402
from qgd_tpu.ops import hermite as jh  # noqa: E402
import qgd_tpu_torch as qt  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-13


def test_hermite_coefficients_equal():
    for m in range(1, 7):
        assert qt.hermite_coefficients(m) == jh.hermite_coefficients(m)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_generator_stack_recursion_and_sides_match_jax(m):
    jprob = jm.cnot2_problem(tf=11.0, nsteps=20)
    tprob = qt.cnot2_problem(tf=11.0, nsteps=20, device="cpu")
    rng = np.random.default_rng(m)
    S = 2
    p = rng.standard_normal((S, m, 2)) * 0.2
    q = rng.standard_normal((S, m, 2)) * 0.2
    w = rng.standard_normal((S, 8, 4))
    dt = 0.55

    A = qt.assemble_generator_stack(tprob, torch.tensor(p), torch.tensor(q),
                                    m)
    Ws = qt.scaled_derivatives(A, torch.tensor(w), m)
    eye = torch.eye(8, dtype=torch.float64)
    D = qt.scaled_derivatives(A, eye, m)
    rhs, lhs = qt.build_rhs(Ws, dt, m), qt.build_lhs(D, dt, m)
    assert A.shape == (S, m, 8, 8) and Ws.shape == (S, m + 1, 8, 4)
    for s in range(S):
        Aj = jh.assemble_generator_stack(jprob, jnp.asarray(p[s]),
                                         jnp.asarray(q[s]), m)
        Wj = jh.scaled_derivatives(Aj, jnp.asarray(w[s]), m)
        Dj = jh.scaled_derivatives(Aj, jnp.eye(8), m)
        for ours, ref in ((A[s], Aj), (Ws[s], Wj), (D[s], Dj),
                          (rhs[s], jh.build_rhs(Wj, dt, m)),
                          (lhs[s], jh.build_lhs(Dj, dt, m))):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=TOL, atol=TOL)


def test_hermite_helpers_match_jax():
    """adjoint_scaled_derivatives, taylor_expand, step_matrices and the
    dense form_lhs/rhs_matrix against qgd_tpu.ops.hermite."""
    m = 3
    jprob = jm.cnot2_problem(tf=11.0, nsteps=20)
    tprob = qt.cnot2_problem(tf=11.0, nsteps=20, device="cpu")
    rng = np.random.default_rng(9)
    p, q = (rng.standard_normal((2, m, 2)) * 0.2 for _ in range(2))
    w = rng.standard_normal((8, 4))
    A = qt.assemble_generator_stack(tprob, torch.tensor(p), torch.tensor(q),
                                    m)
    Aj = [jh.assemble_generator_stack(jprob, jnp.asarray(p[i]),
                                      jnp.asarray(q[i]), m) for i in (0, 1)]
    L = qt.adjoint_scaled_derivatives(A[0], torch.tensor(w), m)
    Ws = qt.scaled_derivatives(A[0], torch.tensor(w), m)
    lhs, rhs = qt.ops.step_matrices(A[0], A[1], 0.55, m)
    jlhs, jrhs = jh.step_matrices(Aj[0], Aj[1], 0.55, m)
    Wj = jh.scaled_derivatives(Aj[0], jnp.asarray(w), m)
    from qgd_tpu.controls import BSpline2Control as JB

    pcof = rng.standard_normal(20) * 0.1
    jc, tc = (JB(5, 11.0), JB(5, 11.0)), (qt.BSpline2Control(5, 11.0),) * 2
    for ours, ref in (
            (L, jh.adjoint_scaled_derivatives(Aj[0], jnp.asarray(w), m)),
            (qt.taylor_expand(Ws, 0.55, m), jh.taylor_expand(Wj, 0.55, m)),
            (lhs, jlhs), (rhs, jrhs),
            (qt.form_lhs_matrix(tprob, tc, 3.3, pcof, 0.55, 2 * m),
             jh.form_lhs_matrix(jprob, jc, 3.3, jnp.asarray(pcof), 0.55,
                                2 * m)),
            (qt.form_rhs_matrix(tprob, tc, 3.3, pcof, 0.55, 2 * m),
             jh.form_rhs_matrix(jprob, jc, 3.3, jnp.asarray(pcof), 0.55,
                                2 * m))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)
