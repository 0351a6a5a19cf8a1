"""The ported main path — CNOT3 objective + discrete-adjoint gradient,
order 4, solver="schulz" with warm budget 0, segment length L = 1 —
against qgd_tpu.segmented.segmented_objective_and_gradient with
n_segments = nsteps, on the CPU.

Tolerances: f64 (j1, guard, grad) relative <= 1e-11 — perturbing the f32
drift inverse by 1e-7 moves the JAX gradient by ~5e-14 relative on this
slice, so only summation order separates the two; f32 at the same
refinement sweep count on both sides, objective <= 1e-5 and gradient
<= 1e-4 relative. A wrong term shows at 1e-2 or more.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
from qgd_tpu.diagnostics import stage_residuals as j_stage_residuals  # noqa
from qgd_tpu.ops import linalg as jl  # noqa: E402
from qgd_tpu.segmented import segmented_objective_and_gradient as j_seg  # noqa
import qgd_tpu_torch as qt  # noqa: E402

torch.set_num_threads(1)

NSTEPS, TF, S = 8, 4.4, 2          # dt = 0.55, the main path's step
SETTINGS = dict(solver="schulz", schulz_iters=48, schulz_warm_budget=0)


def _inputs():
    pcof = np.random.default_rng(0).standard_normal((S, 60)) * 0.01
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))
    return pcof, tgt


def _problems(dtype, **over):
    kw = dict(SETTINGS, **over)
    jprob = dataclasses.replace(
        qgd_tpu.models.cnot3_problem(tf=TF, nsteps=NSTEPS), dtype=dtype, **kw)
    tprob = qt.cnot3_problem(tf=TF, nsteps=NSTEPS, dtype=dtype, **kw)
    jc = tuple(qgd_tpu.BSpline2Control(10, TF) for _ in range(3))
    tc = tuple(qt.BSpline2Control(10, TF) for _ in range(3))
    return jprob, jc, tprob, tc


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype,tol_obj,tol_grad", [
    ("float64", 1e-11, 1e-11),
    ("float32", 1e-5, 1e-4),
])
def test_cnot3_l1_slice_matches_jax(dtype, tol_obj, tol_grad):
    pcof, tgt = _inputs()
    jprob, jc, tprob, tc = _problems(dtype)
    (j1, guard, ridge), grad = qt.segmented_objective_and_gradient(
        tprob, tc, pcof, tgt, 4, ridge_penalty_strength=1e-3,
        refine_sweeps=jl.REFINE_SWEEPS_F32)
    assert grad.shape == (S, 60) and grad.dtype == torch.float64
    assert j1.shape == guard.shape == ridge.shape == (S,)
    for s in range(S):
        (jj1, jg, jr), jgrad = j_seg(jprob, jc, jnp.asarray(pcof[s]), tgt, 4,
                                     ridge_penalty_strength=1e-3,
                                     n_segments=NSTEPS)
        assert _rel(j1[s], jj1) <= tol_obj
        assert _rel(guard[s], jg) <= tol_obj
        assert _rel(ridge[s], jr) <= 1e-14
        assert _rel(grad[s], jgrad) <= tol_grad


def test_single_control_vector_and_auto_segments():
    """A 1-D pcof gives scalars; n_segments = 0 picks L = 1."""
    pcof, tgt = _inputs()
    _, _, tprob, tc = _problems("float64")
    (j1b, gb, _), gradb = qt.segmented_objective_and_gradient(
        tprob, tc, pcof[:1], tgt, 4, n_segments=NSTEPS)
    (j1, g, _), grad = qt.segmented_objective_and_gradient(
        tprob, tc, pcof[0], tgt, 4)
    assert j1.dim() == 0 and grad.shape == (60,)
    assert float(j1) == float(j1b[0]) and float(g) == float(gb[0])
    assert torch.equal(grad, gradb[0])


def test_unported_routes_raise():
    pcof, tgt = _inputs()
    _, _, tprob, tc = _problems("float64")
    with pytest.raises(NotImplementedError):
        qt.segmented_objective_and_gradient(tprob, tc, pcof, tgt, 4,
                                            n_segments=4)
    with pytest.raises(NotImplementedError):
        qt.segmented_objective_and_gradient(
            dataclasses.replace(tprob, solver="lu"), tc, pcof, tgt, 4)


@pytest.mark.parametrize("cost_type", ["Tracking", "Norm"])
def test_other_terminal_costs_match_jax(cost_type):
    pcof, tgt = _inputs()
    jprob, jc, tprob, tc = _problems("float64")
    (j1, guard, _), grad = qt.segmented_objective_and_gradient(
        tprob, tc, pcof[:1], tgt, 4, cost_type=cost_type)
    (jj1, jg, _), jgrad = j_seg(jprob, jc, jnp.asarray(pcof[0]), tgt, 4,
                                cost_type=cost_type, n_segments=NSTEPS)
    assert _rel(j1[0], jj1) <= 1e-11
    assert _rel(grad[0], jgrad) <= 1e-11


@pytest.mark.parametrize("warm,lo,hi", [(8, 0.0, 1e-7), (0, 1e-7, 1e-4)])
def test_gradient_matches_central_differences_f64(warm, lo, hi):
    """Narrow problem (CNOT2, 2 x BSpline2Control(5), dt = 0.55): the f64
    gradient against central differences (h = 1e-5) along two random
    directions. Warm budget 8 agrees to <= 1e-7 relative. Warm budget 0
    does not: the refinement error of that route shows in f64 (8.1e-6 and
    2.0e-7 along these directions, in JAX as in the port), and the port
    keeps that route as it is, so its worst direction lies between 1e-7
    and 1e-4."""
    prob = qt.cnot2_problem(tf=11.0, nsteps=20, solver="schulz",
                            schulz_iters=48, schulz_warm_budget=warm)
    ctrls = tuple(qt.BSpline2Control(5, prob.tf) for _ in range(2))
    rng = np.random.default_rng(4)
    pcof = rng.standard_normal(20) * 0.05
    tgt = np.eye(4)[:, [0, 1, 3, 2]].astype(complex)      # CNOT
    (_, _, _), grad = qt.segmented_objective_and_gradient(prob, ctrls, pcof,
                                                          tgt, 4)
    dirs = rng.standard_normal((2, 20))
    h = 1e-5
    batch = np.concatenate([pcof + h * dirs, pcof - h * dirs])
    (j1, guard, _), _ = qt.segmented_objective_and_gradient(prob, ctrls,
                                                            batch, tgt, 4)
    J = (j1 + guard).numpy()
    fd = (J[:2] - J[2:]) / (2 * h)
    exact = dirs @ grad.numpy()
    assert lo < np.max(np.abs(fd - exact) / np.abs(exact)) <= hi


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-3), ("float32", 1e-2)])
def test_stage_residuals_match_jax(dtype, rtol):
    """At warm budget 0 the residual is the refinement's truncation error,
    which both packages reach alike (f32 within its roundoff)."""
    pcof, _ = _inputs()
    jprob, jc, tprob, tc = _problems(dtype)
    ours = qt.stage_residuals(tprob, tc, pcof[:1], 4, sample=4,
                              refine_sweeps=jl.REFINE_SWEEPS_F32)
    ref = j_stage_residuals(jprob, jc, jnp.asarray(pcof[0]), 4, sample=4)
    assert ours["n_sampled"] == ref["n_sampled"] == 4
    assert ours["solver"] == "schulz"
    np.testing.assert_allclose(ours["max"], ref["max"], rtol=rtol)
    np.testing.assert_allclose(ours["mean"], ref["mean"], rtol=rtol)
    if dtype == "float32":
        # the port's default 3 sweeps reach the f32 roundoff floor
        assert qt.stage_residuals(tprob, tc, pcof, 4, sample=4)["max"] <= 1e-6
