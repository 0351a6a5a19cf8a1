"""qgd_tpu_torch control tables of every family and their pcof VJP
against qgd_tpu.controls, float64 at 1e-14 (relative and absolute: the
same arithmetic, in the same order where the form is closed; the de Boor
and Hermite derivative columns come from another evaluation order of the
same polynomials, ~1e-15 relative); the scalar control API; the Hermite
sampling helpers; and the port's native de Boor library against scipy and
the recurrence (1e-11 and 1e-14, tests/test_native.py's gates)."""

import math

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


def _families(pkg, tf):
    """Carrier-wave controls over B-spline and GRAPE envelopes with the
    CNOT3 sideband frequencies, and piecewise-constant and -quadratic
    GRAPE."""
    freqs = qgd_tpu.models.cnot3_carrier_frequencies()
    return (pkg.CarrierControl(pkg.BSpline2Control(10, tf), freqs[0]),
            pkg.CarrierControl(pkg.GRAPEControl(4, tf), freqs[1]),
            pkg.GRAPEControl(3, tf),
            pkg.GeneralGRAPEControl(5, tf, 2))


def test_carrier_and_grape_tables_and_vjp_match_jax():
    """At m = 3 (order 6); the m = 1 and m = 2 tables are its first
    columns."""
    tf, nsteps, m = 550.0, 24, 3
    jc, tc = _families(qgd_tpu, tf), _families(qt, tf)
    n_par = qt.total_control_parameters(tc)
    assert n_par == qgd_tpu.controls.total_control_parameters(jc) == 100
    rng = np.random.default_rng(11)
    pcof = rng.standard_normal((2, n_par)) * 0.01
    ts = np.arange(nsteps + 1, dtype=np.float64) * (tf / nsteps)
    cot = rng.standard_normal((2, 2, nsteps + 1, m, len(tc)))
    pc = torch.tensor(pcof, requires_grad=True)
    P, Q = qt.control_tables(tc, pc, torch.tensor(ts), m)
    (grad,) = torch.autograd.grad((P, Q), pc,
                                  (torch.tensor(cot[0]), torch.tensor(cot[1])))

    @jax.jit
    def tables_and_vjp(p, c0, c1):
        (Pj, Qj), vjp = jax.vjp(lambda x: j_tables(jc, x, jnp.asarray(ts), m),
                                p)
        return Pj, Qj, vjp((c0, c1))[0]

    for s in range(2):
        Pj, Qj, gj = tables_and_vjp(jnp.asarray(pcof[s]),
                                    jnp.asarray(cot[0, s]),
                                    jnp.asarray(cot[1, s]))
        for ours, ref in ((P[s].detach(), Pj), (Q[s].detach(), Qj),
                          (grad[s], gj)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=TOL, atol=TOL)


def test_cnot3_carrier_configuration():
    """The flagship controls: 3 x CarrierControl(BSpline2Control(10), 3
    sideband frequencies) = 180 parameters, frequencies as in JAX."""
    freqs = qt.cnot3_carrier_frequencies()
    np.testing.assert_array_equal(
        np.asarray(freqs),
        np.asarray(qgd_tpu.models.cnot3_carrier_frequencies()))
    ctrls = [qt.CarrierControl(qt.BSpline2Control(10, 550.0), f)
             for f in freqs]
    assert qt.total_control_parameters(ctrls) == 180
    assert ctrls[0].N_freq == 3 and ctrls[0].N_coeffs_per_frequency == 20


def test_control_bookkeeping():
    ctrls = (qt.BSpline2Control(10, 1.0), qt.BSpline2Control(5, 1.0))
    assert qt.total_control_parameters(ctrls) == 30
    pcof = torch.arange(60.0).reshape(2, 30)
    assert torch.equal(qt.control_vector_slice(pcof, ctrls, 1),
                       pcof[:, 20:30])
    with pytest.raises(ValueError):
        qt.BSpline2Control(2, 1.0)


FAMILIES = {
    "trig": lambda P, tf: [P.SinCosControl(tf, 1.3), P.SinControl(tf, 0.7),
                           P.CosControl(tf, 2.0),
                           P.SquaredAmpCosControl(tf, 1.1),
                           P.SingleSymCosControl(tf, 0.9),
                           P.ZeroControl(tf, 0)],
    "general_bspline": lambda P, tf: [P.GeneralBSplineControl(3, 5, tf)],
    "fortran_bspline": lambda P, tf: [P.FortranBSplineControl(4, 9, tf)],
    "hermite_heuristic": lambda P, tf: [P.HermiteControl(5, tf, 2)],
    "hermite_taylor": lambda P, tf: [P.HermiteControl(4, tf, 1, "Taylor")],
    "hermite_derivative": lambda P, tf: [
        P.HermiteControl(4, tf, 3, "Derivative")],
    "hermite_carrier": lambda P, tf: [
        P.HermiteCarrierControl(4, tf, 1, [0.5, -1.5])],
    "bspline_carrier": lambda P, tf: [P.BSplineControl(tf, 5, [0.3, -0.8])],
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_other_families_tables_and_vjp_match_jax(family):
    """Tables at m = 4 (derivatives to the third) over a grid that includes
    knot and control points and tf, for two control vectors, and their
    pcof VJP."""
    tf, m = 3.0, 4
    jc, tc = FAMILIES[family](qgd_tpu, tf), FAMILIES[family](qt, tf)
    n = qt.total_control_parameters(tc)
    assert n == qgd_tpu.total_control_parameters(jc)
    rng = np.random.default_rng(5)
    pcof = rng.standard_normal((2, n)) * 0.5
    ts = np.linspace(0.0, tf, 37)
    cot = rng.standard_normal((2, 2, ts.size, m, len(tc)))
    pc = torch.tensor(pcof, requires_grad=True)
    P, Q = qt.control_tables(tc, pc, torch.tensor(ts), m)
    (grad,) = torch.autograd.grad(
        (P, Q), pc, (torch.tensor(cot[0]), torch.tensor(cot[1])))

    @jax.jit
    def ref(p, cP, cQ):
        tables, vjp = jax.vjp(lambda q: j_tables(jc, q, jnp.asarray(ts), m),
                              p)
        return tables, vjp((cP, cQ))[0]

    for s in range(2):
        (Pj, Qj), gj = ref(jnp.asarray(pcof[s]), jnp.asarray(cot[0, s]),
                           jnp.asarray(cot[1, s]))
        for ours, want in ((P[s], Pj), (Q[s], Qj), (grad[s], gj)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                ours.detach().numpy(), want, rtol=TOL,
                atol=TOL * max(1.0, np.abs(want).max()))


def test_scalar_control_api_matches_jax():
    """eval_p/q, their derivatives and the derivatives' pcof gradients;
    taylor_coefficients and local_control_index."""
    from qgd_tpu import controls as jcs
    from qgd_tpu_torch import controls as tcs

    tf = 3.0
    for build in (lambda P: P.FortranBSplineControl(3, 7, tf),
                  lambda P: P.SquaredAmpCosControl(tf, 1.1)):
        jc, tc = build(qgd_tpu), build(qt)
        pcof = np.random.default_rng(6).standard_normal(tc.N_coeff) * 0.5
        for t in (0.7, tf):
            for ours, ref in (
                    (tcs.eval_p(tc, t, pcof), jcs.eval_p(jc, t, pcof)),
                    (tcs.eval_q(tc, t, pcof), jcs.eval_q(jc, t, pcof))):
                np.testing.assert_allclose(float(ours), float(ref),
                                           rtol=TOL, atol=TOL)
        t, k = 0.7, 2
        for ours, ref in (
                (tcs.eval_p_derivative(tc, t, pcof, k),
                 jcs.eval_p_derivative(jc, t, pcof, k)),
                (tcs.eval_q_derivative(tc, t, pcof, k),
                 jcs.eval_q_derivative(jc, t, pcof, k)),
                (tcs.eval_grad_p_derivative(tc, t, pcof, k),
                 jcs.eval_grad_p_derivative(jc, t, pcof, k)),
                (tcs.eval_grad_q_derivative(tc, t, pcof, k),
                 jcs.eval_grad_q_derivative(jc, t, pcof, k))):
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                np.asarray(ours), ref, rtol=1e-13,
                atol=1e-13 * max(1.0, np.abs(ref).max()))
    f = lambda t: torch.sin(1.7 * t) * t ** 2
    jf = lambda t: jnp.sin(1.7 * t) * t ** 2
    np.testing.assert_allclose(tcs.taylor_coefficients(f, 0.9, 5).numpy(),
                               np.asarray(jcs.taylor_coefficients(jf, 0.9, 5)),
                               rtol=TOL, atol=TOL)
    ctrls = FAMILIES["trig"](qt, tf)
    for g in (0, 3, 8):
        assert (tcs.local_control_index(ctrls, g)
                == jcs.local_control_index(FAMILIES["trig"](qgd_tpu, tf), g))


def test_hermite_sampling_matches_jax():
    """sample_from_controls / construct_pcof_from_sample reproduce a
    B-spline control as Hermite data, as in JAX."""
    from qgd_tpu.controls import hermite as jhc
    from qgd_tpu_torch.controls import hermite as thc

    tf = 3.0
    orig_j = [qgd_tpu.BSpline2Control(6, tf), qgd_tpu.SinCosControl(tf, 0.8)]
    orig_t = [qt.BSpline2Control(6, tf), qt.SinCosControl(tf, 0.8)]
    pcof = np.random.default_rng(8).standard_normal(14) * 0.4
    jcs_, jpc = jhc.sample_from_controls(orig_j, jnp.asarray(pcof), 5, 2)
    tcs_, tpc = thc.sample_from_controls(orig_t, pcof, 5, 2)
    assert len(tcs_) == len(jcs_) == 2
    np.testing.assert_allclose(tpc.numpy(), np.asarray(jpc), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(thc.hermite_interp_map(3, 0.3),
                               jhc.hermite_interp_map(3, 0.3), rtol=0, atol=0)


def test_native_de_boor_library():
    """The port's own build of bsplvd.cc: bsplvb against the recurrence,
    bsplvd against scipy's BSpline, the batched tables against the de
    Boor control's derivative columns."""
    from scipy.interpolate import BSpline

    from qgd_tpu_torch.controls.deboor import (clamped_uniform_knots,
                                               deboor_nonzero_values)
    from qgd_tpu_torch.native import (bsplvb, bsplvd, bspline_tables,
                                      native_available)

    assert native_available()
    for degree, n_distinct in ((2, 5), (3, 6), (5, 4)):
        k = degree + 1
        knots = clamped_uniform_knots(k, n_distinct)
        for x in np.linspace(0.02, 0.98, 9):
            left = degree + min(int(x * (n_distinct - 1)), n_distinct - 2)
            np.testing.assert_allclose(
                bsplvb(knots, k, x, left),
                deboor_nonzero_values(knots, k, torch.tensor(x),
                                      left).numpy(), rtol=0, atol=TOL)
            table = bsplvd(knots, k, x, left, min(k, 3))
            for i in range(k):
                c = np.zeros(len(knots) - k)
                c[left - k + 1 + i] = 1.0
                spl = BSpline(knots, c, degree)
                for m in range(table.shape[1]):
                    expect = spl.derivative(m)(x) if m else spl(x)
                    assert abs(table[i, m] - expect) < 1e-11
    ctrl = qt.FortranBSplineControl(3, 7, 2.0)
    pcof = np.random.default_rng(0).standard_normal(ctrl.N_coeff)
    ts = np.linspace(0.05, 1.95, 7)
    vals, offsets = bspline_tables(ctrl.knot_vector, 4, ctrl.N_distinct_knots,
                                   ts / 2.0, 3)
    P, _ = qt.control_tables([ctrl], torch.tensor(pcof), ts, 3)
    for ix in range(ts.size):
        taps = pcof[offsets[ix]:offsets[ix] + 4]
        for m in range(3):
            native = float(vals[ix, m] @ taps) / 2.0 ** m / math.factorial(m)
            assert abs(native - float(P[ix, m, 0])) < 1e-10 * max(
                1.0, abs(float(P[ix, m, 0])))
    with pytest.raises(ValueError):
        bsplvd(clamped_uniform_knots(4, 5), 4, 0.5, 8, 2)
