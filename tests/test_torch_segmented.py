"""The ported segmented route against qgd_tpu.segmented on the CPU: the
main path's CNOT3 objective + discrete-adjoint gradient at segment length
L = 1 (order 4, solver="schulz" with warm budget 0) and at general L with
both solvers, the segment chooser, the thinned forward history and the
stage-residual diagnostic.

Tolerances: f64 (j1, guard, grad) relative <= 1e-11 at L = 1 — perturbing
the f32 drift inverse by 1e-7 moves the JAX gradient by ~5e-14 relative on
this slice, so only summation order separates the two; <= 1e-12 at general
L, against JAX and against the port's plain route (the same arithmetic in
another order); f32 at the same refinement sweep count on both sides,
objective <= 1e-5 and gradient <= 1e-4 relative. Thinned histories
<= 1e-13 relative. A wrong term shows at 1e-2 or more.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
from qgd_tpu.diagnostics import stage_residuals as j_stage_residuals  # noqa
from qgd_tpu.ops import linalg as jl  # noqa: E402
from qgd_tpu.forward import eval_forward as j_eval_forward  # noqa: E402
from qgd_tpu.segmented import choose_segments as j_choose  # noqa: E402
from qgd_tpu.segmented import segmented_objective_and_gradient as j_seg  # noqa
import qgd_tpu_torch as qt  # noqa: E402
from qgd_tpu_torch import segmented as seg  # noqa: E402
from qgd_tpu_torch.segmented import _auto_segments  # noqa: E402

torch.set_num_threads(1)

NSTEPS, TF, S = 8, 4.4, 2          # dt = 0.55, the main path's step
SETTINGS = dict(solver="schulz", schulz_iters=48, schulz_warm_budget=0)


def _inputs():
    pcof = np.random.default_rng(0).standard_normal((S, 60)) * 0.01
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))
    return pcof, tgt


def _problems(dtype, tf=TF, nsteps=NSTEPS, **over):
    kw = dict(SETTINGS, **over)
    jprob = dataclasses.replace(
        qgd_tpu.models.cnot3_problem(tf=tf, nsteps=nsteps), dtype=dtype, **kw)
    tprob = qt.cnot3_problem(tf=tf, nsteps=nsteps, dtype=dtype, device="cpu",
                             **kw)
    jc = tuple(qgd_tpu.BSpline2Control(10, tf) for _ in range(3))
    tc = tuple(qt.BSpline2Control(10, tf) for _ in range(3))
    return jprob, jc, tprob, tc


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype,tol_obj,tol_grad", [
    ("float64", 1e-11, 1e-11),
    ("float32", 1e-5, 1e-4),
])
def test_cnot3_l1_slice_matches_jax(dtype, tol_obj, tol_grad, monkeypatch):
    """L = 1 runs blocks of K steps (``_block_length``): one block of 8
    here, and, with the block target at 2, four blocks of 2 through the
    same programs, each block's state and multiplier handed on."""
    pcof, tgt = _inputs()
    jprob, jc, tprob, tc = _problems(dtype)
    runs = []
    for block in (seg._BLOCK_STEPS, 2):
        monkeypatch.setattr(seg, "_BLOCK_STEPS", block)
        runs.append(qt.segmented_objective_and_gradient(
            tprob, tc, pcof, tgt, 4, ridge_penalty_strength=1e-3,
            refine_sweeps=jl.REFINE_SWEEPS_F32))
    assert seg._block_length(NSTEPS) == 2
    (j1, guard, ridge), grad = runs[0]
    assert grad.shape == (S, 60) and grad.dtype == torch.float64
    assert j1.shape == guard.shape == ridge.shape == (S,)
    for s in range(S):
        (jj1, jg, jr), jgrad = j_seg(jprob, jc, jnp.asarray(pcof[s]), tgt, 4,
                                     ridge_penalty_strength=1e-3,
                                     n_segments=NSTEPS)
        for (j1, guard, ridge), grad in runs:
            assert _rel(j1[s], jj1) <= tol_obj
            assert _rel(guard[s], jg) <= tol_obj
            assert _rel(ridge[s], jr) <= 1e-14
            assert _rel(grad[s], jgrad) <= tol_grad


def test_single_control_vector_and_auto_segments():
    """A 1-D pcof gives scalars; n_segments = 0 on the CPU takes the
    sqrt-length rule, as in JAX (nsteps = 8: 4 segments of 2 steps). A
    ``SegmentGraphs`` kept across the calls serves both from one set of
    segment programs, and the value-only call from its forward."""
    pcof, tgt = _inputs()
    _, _, tprob, tc = _problems("float64")
    assert _auto_segments(tprob, NSTEPS, S) == j_choose(NSTEPS) == 4
    graphs = qt.SegmentGraphs()
    (j1b, gb, _), gradb = qt.segmented_objective_and_gradient(
        tprob, tc, pcof[:1], tgt, 4, n_segments=4, graphs=graphs)
    (j1, g, _), grad = qt.segmented_objective_and_gradient(
        tprob, tc, pcof[0], tgt, 4, graphs=graphs)
    val = qt.segmented_objective_value(tprob, tc, pcof[0], tgt, 4,
                                       graphs=graphs)
    assert len(graphs._programs) == 1
    assert j1.dim() == 0 and grad.shape == (60,)
    assert float(j1) == float(j1b[0]) and float(g) == float(gb[0])
    assert float(val) == float(j1 + g)
    assert torch.equal(grad, gradb[0])


def test_unported_routes_raise():
    """What the route cannot take raises: a segment count that does not
    divide nsteps. The GMRES solver, once refused, builds on CNOT3 and
    takes a step that agrees with the LU step to 1e-12 (with the diagonal
    preconditioner; unpreconditioned, 20 Arnoldi steps leave 2e-6 at this
    step size, in JAX as in the port)."""
    pcof, tgt = _inputs()
    _, _, tprob, tc = _problems("float64")
    with pytest.raises(ValueError, match="must divide"):
        qt.segmented_objective_and_gradient(tprob, tc, pcof, tgt, 4,
                                            n_segments=3)
    with pytest.raises(ValueError, match="must divide"):
        qt.segmented_objective_value(tprob, tc, pcof, tgt, 4, n_segments=5)
    dt = TF / NSTEPS
    gprob = qt.cnot3_problem(tf=dt, nsteps=1, solver="gmres",
                             preconditioner_type="diagonal", device="cpu")
    assert gprob.solver == "gmres" and gprob.gmres_iters == 20
    lprob = qt.cnot3_problem(tf=dt, nsteps=1, device="cpu")
    tc1 = tuple(qt.BSpline2Control(10, dt) for _ in range(3))
    step = qt.eval_forward(gprob, tc1, pcof[0], 4)
    assert step.shape == (2, 128, 8)
    ref = qt.eval_forward(lprob, tc1, pcof[0], 4)
    assert float((step - ref).abs().max()) <= 1e-12


@pytest.mark.parametrize("solver", ["schulz", "lu"])
@pytest.mark.parametrize("L", [2, 8])
def test_general_segment_length_matches_jax(solver, L):
    """nsteps = 16 in 16 / L segments: the re-forward route, against JAX
    and against the port's plain route, the value-only forward too."""
    pcof, tgt = _inputs()
    jprob, jc, tprob, tc = _problems("float64", solver=solver, tf=2 * TF,
                                     nsteps=2 * NSTEPS)
    kw = dict(ridge_penalty_strength=1e-3, n_segments=2 * NSTEPS // L)
    (j1, guard, ridge), grad = qt.segmented_objective_and_gradient(
        tprob, tc, pcof, tgt, 4, **kw)
    val = qt.segmented_objective_value(tprob, tc, pcof, tgt, 4, **kw)
    (pj1, pg, _), pgrad = qt.objective_and_gradient(
        tprob, tc, pcof, tgt, 4, ridge_penalty_strength=1e-3)
    for s in range(S):
        (jj1, jg, jr), jgrad = j_seg(jprob, jc, jnp.asarray(pcof[s]), tgt, 4,
                                     **kw)
        assert _rel(j1[s], jj1) <= 1e-12 and _rel(guard[s], jg) <= 1e-12
        assert _rel(grad[s], jgrad) <= 1e-12
        assert _rel(val[s], jj1 + jg + jr) <= 1e-12
        assert _rel(j1[s], pj1[s]) <= 1e-12 and _rel(guard[s], pg[s]) <= 1e-12
        assert _rel(grad[s], pgrad[s]) <= 1e-12


def test_order8_segmented_matches_jax():
    """Order 8 (m = 4: the recursion's levels j >= 2, which the LHS kernel
    runs as level launches on the card) on the general-L route, f64,
    nsteps = 9 in 3 segments at the main path's step, S = 2: objective and
    gradient against JAX at 1e-11 relative (summation order only), one JAX
    compile for both scenarios. From order 6 on the tables hold the
    splines' second derivatives, which jump at the knots (every tf/8 for
    BSpline2Control(10)); an odd step count keeps the interior grid off
    the knots, where rounding picks the side (at nsteps = 8 the packages
    part there, 3e-5 in the objective)."""
    pcof, tgt = _inputs()
    jprob, jc, tprob, tc = _problems("float64", tf=9 * TF / NSTEPS,
                                     nsteps=9)
    (j1, guard, _), grad = qt.segmented_objective_and_gradient(
        tprob, tc, pcof, tgt, 8, n_segments=3)
    for s in range(S):
        (jj1, jg, _), jgrad = j_seg(jprob, jc, jnp.asarray(pcof[s]), tgt, 8,
                                    n_segments=3)
        assert _rel(j1[s], jj1) <= 1e-11 and _rel(guard[s], jg) <= 1e-11
        assert _rel(grad[s], jgrad) <= 1e-11


def test_choose_segments_matches_jax():
    """The divisor chosen from the factorization is JAX's, with and
    without a target length (the prefix route's rule), a prime included."""
    for n in (1, 64, 997, 1000, 5500, 20480):
        for target in (0, max(256, int(n ** 0.5))):
            assert qt.choose_segments(n, target) == j_choose(n, target), \
                (n, target)


def test_auto_rule_on_the_card():
    """f32 on the card: the largest segment count whose stored states fit
    4 GB, counting the L = 1 route's trajectory and multipliers. The main
    path (CNOT3, nsteps 1000, 256 scenarios, 1 MiB per state) keeps L = 1;
    at the published 5500 steps it takes L = 2; f64 takes the sqrt rule."""
    card = types.SimpleNamespace(
        device=torch.device("cuda"), work_dtype=torch.float32,
        real_system_size=128, N_initial_conditions=8)
    assert _auto_segments(card, 1000, 256) == 1000
    assert _auto_segments(card, 5500, 256) == 2750
    assert _auto_segments(card, 5500, 1) == 5500
    card.work_dtype = torch.float64
    assert _auto_segments(card, 5500, 256) == j_choose(5500)


@functools.lru_cache(maxsize=None)
def _jax_thinned(save_every, s):
    """JAX's thinned history with derivative columns for scenario ``s``;
    its level-0 column is the thinned history itself (one compile per
    ``save_every`` serves both cases)."""
    pcof, _ = _inputs()
    jprob, jc, _, _ = _problems("float64", solver="lu", tf=4 * TF,
                                nsteps=4 * NSTEPS)
    return np.asarray(j_eval_forward(jprob, jc, jnp.asarray(pcof[s]), 4,
                                     save_every=save_every,
                                     return_derivatives=True))


@pytest.mark.parametrize("derivatives", [False, True])
@pytest.mark.parametrize("save_every", [4, 16])
def test_thinned_eval_forward_matches_jax(save_every, derivatives):
    """eval_forward(save_every > 1) from segments of save_every steps,
    with the scaled-derivative columns or without, against JAX and
    against the slice of the port's full history."""
    pcof, _ = _inputs()
    _, _, tprob, tc = _problems("float64", solver="lu", tf=4 * TF,
                                nsteps=4 * NSTEPS)
    thin = qt.eval_forward(tprob, tc, pcof, 4, save_every=save_every,
                           return_derivatives=derivatives)
    n_saved = 4 * NSTEPS // save_every + 1
    assert thin.shape[:2] == (S, n_saved)
    for s in range(S):
        ref = _jax_thinned(save_every, s)
        assert _rel(thin[s], ref if derivatives else ref[:, 0]) <= 1e-13
    full = qt.eval_forward(tprob, tc, pcof, 4, return_derivatives=derivatives)
    assert _rel(thin, full[:, ::save_every]) <= 1e-13


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
    prob = qt.cnot2_problem(tf=11.0, nsteps=20, solver="schulz", device="cpu",
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


def test_stage_residuals_lu_matches_jax():
    """solver="lu": the residual is f64 roundoff, in both packages."""
    pcof, _ = _inputs()
    jprob, jc, tprob, tc = _problems("float64", solver="lu")
    ours = qt.stage_residuals(tprob, tc, pcof, 4, sample=4)
    ref = j_stage_residuals(jprob, jc, jnp.asarray(pcof[0]), 4, sample=4)
    assert ours["solver"] == ref["solver"] == "lu"
    assert ours["n_sampled"] == 2 * ref["n_sampled"] == 8
    assert ours["max"] <= 1e-14 and ref["max"] <= 1e-14
