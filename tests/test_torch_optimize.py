"""The port's optimizer drivers against the JAX package on the CPU: the
quick start's ``optimize_gate`` (Rabi SWAP, GRAPE, order 8), its on-device
L-BFGS (``method="lbfgs"``, against optax's zoom line search) and the
batched ``optimize_gate_multistart`` on the plain and segmented routes.

Tolerances: recorded objectives relative <= 1e-9, with an absolute floor
of 1e-14: the infidelity is ``1 - |tr|^2/N^2`` formed from ``|tr|^2/N^2``
near 1, whose float64 resolution is ~1e-16, and the two packages'
propagations differ by ~1e-15 relative, so an objective of 5e-7 carries
~4e-15 of roundoff (the quick start's sixth evaluation). Multistart
objectives relative <= 1e-8 over 3 iterations: the line search compares
those values against thresholds, so a difference would show as a jump,
not a drift.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
import qgd_tpu_torch as qt  # noqa: E402

torch.set_num_threads(1)

SWAP = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=np.complex128)


def _rabi(pkg, nsteps=40, **over):
    if pkg is qgd_tpu:
        prob = dataclasses.replace(pkg.construct_rabi_prob(nsteps=nsteps),
                                   **over)
    else:
        prob = pkg.construct_rabi_prob(nsteps=nsteps, device="cpu", **over)
    return prob, pkg.GRAPEControl(1, float(prob.tf))


def test_optimize_gate_quick_start_matches_jax():
    """The README quick start: the recorded objectives of the first (up to)
    10 evaluations agree with JAX's, and the port alone runs on to the SWAP
    optimum |amp| = 0.5."""
    kw = dict(order=8, ridge_penalty_strength=0.0, print_level=0)
    jprob, jc = _rabi(qgd_tpu)
    tprob, tc = _rabi(qt)
    ref = qgd_tpu.optimize_gate(jprob, jc, jnp.array([0.4, 0.1]), SWAP,
                                maxIter=10, **kw)
    hist = qt.optimize_gate(tprob, tc, np.array([0.4, 0.1]), SWAP,
                            maxIter=60, **kw)
    n = min(10, len(ref.obj_value))
    assert len(hist.obj_value) >= n >= 5
    np.testing.assert_allclose(hist.obj_value[:n], ref.obj_value[:n],
                               rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(np.asarray(hist.pcof[:n]),
                               np.asarray(ref.pcof[:n]), rtol=0, atol=1e-12)
    assert hist.obj_value[hist.best_index] < 1e-7
    assert abs(np.hypot(*hist.best_pcof) - 0.5) < 5e-4
    assert hist.iter_count == list(range(len(hist.obj_value)))
    assert "min objective" in hist.summary()


@pytest.mark.parametrize("route,solver", [("plain", "lu"),
                                          ("segmented", "schulz")])
def test_multistart_matches_jax(route, solver):
    """S = 3 starts, 3 iterations, L-BFGS with backtracking: the port's
    batched torch version against optax's, vmapped. Order 4, as order 8
    adds only JAX compile time here."""
    jprob, jc = _rabi(qgd_tpu, solver=solver)
    tprob, tc = _rabi(qt, solver=solver)
    starts = np.array([[0.4, 0.1], [0.55, -0.05], [0.35, 0.2]])
    kw = dict(order=4, maxIter=3, ridge_penalty_strength=0.0, print_level=0,
              gradient_route=route,
              n_segments=40 if route == "segmented" else 0)
    jp, jobjs = qgd_tpu.optimize_gate_multistart(jprob, jc,
                                                 jnp.asarray(starts), SWAP,
                                                 **kw)
    tp, tobjs = qt.optimize_gate_multistart(tprob, tc, starts, SWAP, **kw)
    assert tobjs.shape == jobjs.shape == (3, 3)
    np.testing.assert_allclose(tobjs, jobjs, rtol=1e-8)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-10)
    assert np.all(tobjs[-1] < tobjs[0])


def test_segmented_route_of_optimize_gate():
    """n_segments > 0 takes the segmented route: at L = 1 and at L = 10
    the same optimization as the plain route (float64, schulz); a segment
    count that does not divide nsteps raises."""
    tprob, tc = _rabi(qt, solver="schulz")
    kw = dict(order=8, maxIter=4, ridge_penalty_strength=1e-2,
              print_level=0)
    plain = qt.optimize_gate(tprob, tc, np.array([0.4, 0.1]), SWAP,
                             n_segments=0, **kw)
    for n_segments in (40, 4):
        seg = qt.optimize_gate(tprob, tc, np.array([0.4, 0.1]), SWAP,
                               n_segments=n_segments, **kw)
        np.testing.assert_allclose(seg.obj_value, plain.obj_value,
                                   rtol=1e-10)
    with pytest.raises(ValueError, match="must divide"):
        qt.optimize_gate(tprob, tc, np.array([0.4, 0.1]), SWAP,
                         n_segments=3, **kw)


def test_unported_options_raise():
    """``max_dispatch_steps`` takes the chunked route now (ported); unknown
    methods and routes still raise."""
    tprob, tc = _rabi(qt)
    p0 = np.array([0.4, 0.1])
    h = qt.optimize_gate(tprob, tc, p0, SWAP, print_level=0, maxIter=2,
                         n_segments=4, max_dispatch_steps=10)
    assert np.all(np.isfinite(h.obj_value)) and len(h.obj_value) >= 2
    for kw in (dict(method="newton"), dict(gradient_route="chunked")):
        with pytest.raises(ValueError):
            qt.optimize_gate(tprob, tc, p0, SWAP, print_level=0, **kw)
    with pytest.raises(ValueError):
        qt.optimize_gate_multistart(tprob, tc, p0[None], SWAP,
                                    gradient_route="chunked", print_level=0)


@pytest.mark.parametrize("bounds", [None, 0.45])
def test_lbfgs_method_matches_optax(bounds):
    """method="lbfgs": optax's lbfgs with its zoom line search, the iterate
    clipped to the box, 4 iterations against the JAX package's run
    (objectives relative <= 1e-10; the bound is active at 0.45)."""
    jprob, jc = _rabi(qgd_tpu)
    tprob, tc = _rabi(qt)
    kw = dict(order=4, ridge_penalty_strength=1e-2, print_level=0,
              method="lbfgs", maxIter=4)
    if bounds is not None:
        kw.update(pcof_L=-bounds, pcof_U=bounds)
    ref = qgd_tpu.optimize_gate(jprob, jc, jnp.array([0.4, 0.1]), SWAP, **kw)
    hist = qt.optimize_gate(tprob, tc, np.array([0.4, 0.1]), SWAP, **kw)
    assert len(hist.obj_value) == len(ref.obj_value) == 4
    np.testing.assert_allclose(hist.obj_value, ref.obj_value, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(hist.pcof), np.asarray(ref.pcof),
                               rtol=0, atol=1e-10)
    assert hist.obj_value[-1] < hist.obj_value[0]
    if bounds is not None:
        assert np.abs(np.asarray(hist.pcof)).max() <= bounds


def test_gradient_descent_decreases_objective():
    tprob, tc = _rabi(qt, nsteps=20)
    p0 = torch.tensor([0.42, 0.03], dtype=torch.float64)
    before = float(qt.infidelity_plus_guard(tprob, tc, p0, SWAP, order=4))
    p1 = qt.gradient_descent(tprob, tc, p0, SWAP, order=4,
                             learning_rate=0.05, max_iter=20)
    after = float(qt.infidelity_plus_guard(tprob, tc, p1, SWAP, order=4))
    assert after < before
