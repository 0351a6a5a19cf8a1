"""The port's gradient checks (qgd_tpu_torch.adjoint: eval_grad_forced,
eval_grad_finite_difference, eval_hessian) against its Lagrange gradient
and against the JAX package's, with the gates of tests/test_gradients.py:
adjoint vs forced rtol 1e-13, atol 1e-14 * max(1, |g|max); vs central
differences 1e-9; the Hessian symmetric to 1e-12, against JAX's
forward-over-Lagrange Hessian relative <= 1e-10 and against the
four-point difference Hessian rtol 1e-4, atol 1e-5. The segmented route at
general L meets the forced gate too (tests/test_segmented.py's, at a
horizon the CPU runs quickly). Coarse steps: exactness holds regardless
of the discretization error. f64 throughout.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
import qgd_tpu_torch as qt  # noqa: E402

torch.set_num_threads(1)


def _case(name):
    """``(jax problem, jax controls, port problem, port controls, pcof,
    target)``, seeded."""
    rng = np.random.default_rng(42)
    if name.startswith("rabi"):
        jprob = qgd_tpu.construct_rabi_prob(nsteps=10)
        tprob = qt.construct_rabi_prob(nsteps=10, device="cpu")
        tf = float(jprob.tf)
        build = {"rabi_grape": lambda P: [P.GRAPEControl(3, tf)],
                 "rabi_bspline": lambda P: [P.BSpline2Control(5, tf)]}[name]
    else:
        jprob = qgd_tpu.models.cnot2_problem(tf=4.0, nsteps=10)
        tprob = qt.cnot2_problem(tf=4.0, nsteps=10, device="cpu")
        build = {
            "cnot2_carrier": lambda P: [
                P.CarrierControl(P.BSpline2Control(4, 4.0), [0.7, 2.1]),
                P.BSpline2Control(4, 4.0)],
            "cnot2_sqcos_hermite": lambda P: [
                P.SquaredAmpCosControl(4.0, 1.3),
                P.HermiteControl(3, 4.0, 1)]}[name]
    jc, tc = build(qgd_tpu), build(qt)
    n = qt.total_control_parameters(tc)
    pcof = rng.standard_normal(n) * 0.3
    shape = (tprob.N_tot_levels, tprob.N_initial_conditions)
    tgt = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return jprob, jc, tprob, tc, pcof, tgt


@pytest.mark.parametrize("name,order", [
    ("rabi_grape", 2), ("rabi_bspline", 4), ("cnot2_carrier", 6),
    ("cnot2_sqcos_hermite", 4)])
def test_forced_gradient_matches_lagrange_and_jax(name, order):
    jprob, jc, tprob, tc, pcof, tgt = _case(name)
    g_for = qt.eval_grad_forced(tprob, tc, pcof, tgt, order).numpy()
    g_adj = qt.discrete_adjoint(tprob, tc, pcof, tgt, order).numpy()
    j_for = np.asarray(qgd_tpu.eval_grad_forced(jprob, jc, jnp.asarray(pcof),
                                                tgt, order))
    scale = max(1.0, np.abs(g_adj).max())
    np.testing.assert_allclose(g_for, g_adj, rtol=1e-13, atol=1e-14 * scale)
    np.testing.assert_allclose(g_for, j_for, rtol=1e-13, atol=1e-14 * scale)


@pytest.mark.parametrize("name", ["rabi_grape", "cnot2_carrier"])
def test_finite_difference_gradient(name):
    """The reference-parity gate (1e-9) against the Lagrange gradient, and
    against JAX's differences (the same perturbed vectors)."""
    jprob, jc, tprob, tc, pcof, tgt = _case(name)
    g_fd = qt.eval_grad_finite_difference(tprob, tc, pcof, tgt, 4).numpy()
    g_adj = qt.discrete_adjoint(tprob, tc, pcof, tgt, 4).numpy()
    j_fd = np.asarray(qgd_tpu.eval_grad_finite_difference(
        jprob, jc, jnp.asarray(pcof), tgt, 4))
    np.testing.assert_allclose(g_fd, g_adj, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(g_fd, j_fd, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name,order", [("rabi_grape", 2),
                                        ("cnot2_sqcos_hermite", 4)])
def test_hessian_matches_jax_and_differences(name, order):
    jprob, jc, tprob, tc, pcof, tgt = _case(name)
    H = qt.eval_hessian(tprob, tc, pcof, tgt, order).numpy()
    np.testing.assert_allclose(H, H.T, atol=1e-12)
    jH = np.asarray(qgd_tpu.eval_hessian(jprob, jc, jnp.asarray(pcof), tgt,
                                         order))
    assert np.abs(H - jH).max() <= 1e-10 * np.abs(jH).max()
    H_fd = qt.eval_hessian(tprob, tc, pcof, tgt, order, method="fd").numpy()
    np.testing.assert_allclose(H, H_fd, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        qt.eval_hessian(tprob, tc, pcof, tgt, order, method="bfgs")


def test_segmented_gradient_matches_forced():
    """The general-L segmented gradient (Rabi, BSpline2Control(4), 128
    steps in the automatic 8 segments of 16) against the forced gradient,
    with the VERDICT gate."""
    tprob = qt.construct_rabi_prob(nsteps=128, device="cpu")
    controls = (qt.BSpline2Control(4, tprob.tf),)
    rng = np.random.default_rng(3)
    pcof = rng.standard_normal(8) * 0.3
    tgt = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    assert qt.choose_segments(128) == 8
    (_, _, _), g_seg = qt.segmented_objective_and_gradient(tprob, controls,
                                                           pcof, tgt, 4)
    g_for = qt.eval_grad_forced(tprob, controls, pcof, tgt, 4).numpy()
    scale = max(1.0, np.abs(g_for).max())
    np.testing.assert_allclose(g_seg.numpy(), g_for, rtol=1e-13,
                               atol=1e-14 * scale)
