"""qgd_tpu_torch B-spline control tables and their pcof VJP against
qgd_tpu.controls, float64 at 1e-14."""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
from qgd_tpu.controls import (control_tables as j_tables,  # noqa: E402
                              control_tables_at as j_tables_at)
import qgd_tpu_torch as qt  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-14


def _setup(D1s, tf, nsteps, S, seed=0):
    rng = np.random.default_rng(seed)
    n_par = sum(2 * d for d in D1s)
    pcof = rng.standard_normal((S, n_par)) * 0.3
    ts = np.arange(nsteps + 1, dtype=np.float64) * (tf / nsteps)
    return pcof, ts


@pytest.mark.parametrize("m", [1, 2, 3])
def test_control_tables_and_vjp_match_jax(m):
    tf, nsteps, D1s = 4.4, 8, (10, 10, 10)
    pcof, ts = _setup(D1s, tf, nsteps, S=2)
    jc = tuple(qgd_tpu.BSpline2Control(d, tf) for d in D1s)
    tc = tuple(qt.BSpline2Control(d, tf) for d in D1s)
    rng = np.random.default_rng(7)
    cot = rng.standard_normal((2, 2, nsteps + 1, m, len(D1s)))

    pc = torch.tensor(pcof, requires_grad=True)
    P, Q = qt.control_tables(tc, pc, torch.tensor(ts), m)
    assert P.shape == (2, nsteps + 1, m, 3)
    (grad,) = torch.autograd.grad((P, Q), pc,
                                  (torch.tensor(cot[0]), torch.tensor(cot[1])))
    for s in range(2):
        (Pj, Qj), vjp = jax.vjp(
            lambda p: j_tables(jc, p, jnp.asarray(ts), m),
            jnp.asarray(pcof[s]))
        (gj,) = vjp((jnp.asarray(cot[0, s]), jnp.asarray(cot[1, s])))
        np.testing.assert_allclose(P[s].detach().numpy(), np.asarray(Pj),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(Q[s].detach().numpy(), np.asarray(Qj),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(grad[s].numpy(), np.asarray(gj),
                                   rtol=TOL, atol=TOL)


def test_tables_at_final_time_and_knot_edges_match_jax():
    """Times on knot boundaries (t = k * dtknot) and t = tf land in the
    same spline interval as in JAX."""
    tf, D1 = 8.0, 6
    jc, tc = qgd_tpu.BSpline2Control(D1, tf), qt.BSpline2Control(D1, tf)
    pcof, _ = _setup((D1,), tf, 4, S=1, seed=3)
    ts = np.array([0.0, 2.0, 4.0, 6.0, 8.0, 1e-12, 8.0 - 1e-12])
    P, Q = qt.control_tables(tc, torch.tensor(pcof), torch.tensor(ts), 3)
    Pj, Qj = j_tables((jc,), jnp.asarray(pcof[0]), jnp.asarray(ts), 3)
    np.testing.assert_allclose(P[0].numpy(), np.asarray(Pj), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(Q[0].numpy(), np.asarray(Qj), rtol=TOL,
                               atol=TOL)
    p_f, q_f = qt.control_tables_at(tc, torch.tensor(pcof[0]), tf, 3)
    pj_f, qj_f = j_tables_at((jc,), jnp.asarray(pcof[0]), jnp.asarray(tf), 3)
    np.testing.assert_allclose(p_f.numpy(), np.asarray(pj_f), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(q_f.numpy(), np.asarray(qj_f), rtol=TOL,
                               atol=TOL)


def test_control_bookkeeping():
    ctrls = (qt.BSpline2Control(10, 1.0), qt.BSpline2Control(5, 1.0))
    assert qt.total_control_parameters(ctrls) == 30
    pcof = torch.arange(60.0).reshape(2, 30)
    assert torch.equal(qt.control_vector_slice(pcof, ctrls, 1),
                       pcof[:, 20:30])
    with pytest.raises(ValueError):
        qt.BSpline2Control(2, 1.0)
