"""The port's plain Lagrange route (forward history, adjoint sweep,
objective_and_gradient, discrete_adjoint, the objective API) and the
value-only segmented forward, against the JAX package on the CPU.

Tolerances: float64 objective and gradient relative <= 1e-11 (the two
packages run the same arithmetic; only summation order and the library
LU separate them, ~1e-15 here); the float32 port against JAX's float64
result: objective <= 1e-5 and gradient <= 1e-4 relative (the float32
propagation's roundoff, ~5e-7 here); autograd through the step loop against
the Lagrange route <= 1e-12 (float64, two derivations of one gradient). A
wrong term shows at 1e-2 or more.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
from qgd_tpu import adjoint as ja, forward as jf, objective as jo  # noqa
from qgd_tpu.segmented import segmented_objective_value as j_seg_value  # noqa
import qgd_tpu_torch as qt  # noqa: E402
from qgd_tpu_torch.adjoint import default_adjoint_method  # noqa: E402
from qgd_tpu_torch.objective import infidelity_of  # noqa: E402

torch.set_num_threads(1)

NSTEPS, TF, S = 8, 4.4, 2          # dt = 0.55, the CNOT3 main path's step


def _controls(pkg):
    """One carrier-wave control and two plain B-splines (70 parameters)."""
    freqs = qgd_tpu.models.cnot3_carrier_frequencies()[0]
    return ((pkg.CarrierControl(pkg.BSpline2Control(10, TF), freqs),)
            + tuple(pkg.BSpline2Control(10, TF) for _ in range(2)))


def _cnot3(solver, dtype):
    jprob = dataclasses.replace(
        qgd_tpu.models.cnot3_problem(tf=TF, nsteps=NSTEPS), solver=solver,
        dtype=dtype)
    tprob = qt.cnot3_problem(tf=TF, nsteps=NSTEPS, solver=solver, dtype=dtype,
                             device="cpu")
    return jprob, tprob


def _inputs(n_par):
    pcof = np.random.default_rng(0).standard_normal((S, n_par)) * 0.01
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))
    return pcof, tgt


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


_JAX_F64 = {}


def _jax_f64_reference(solver, pcof, tgt):
    """JAX's float64 ``objective_and_gradient`` per scenario, compiled and
    run once per solver: the float32 cases are held against it too."""
    if solver not in _JAX_F64:
        jprob, _ = _cnot3(solver, "float64")
        jc = _controls(qgd_tpu)
        _JAX_F64[solver] = [ja.objective_and_gradient(
            jprob, jc, jnp.asarray(p), tgt, 4, ridge_penalty_strength=1e-3)
            for p in pcof]
    return _JAX_F64[solver]


@pytest.mark.parametrize("solver", ["lu", "schulz"])
@pytest.mark.parametrize("dtype,tol_obj,tol_grad", [
    ("float64", 1e-11, 1e-11),
    ("float32", 1e-5, 1e-4),
])
def test_objective_and_gradient_matches_jax(solver, dtype, tol_obj,
                                            tol_grad):
    """The port in ``dtype`` against JAX's float64 result (the float32 port
    sits ~5e-7 from it, well inside the float32 tolerances)."""
    _, tprob = _cnot3(solver, dtype)
    tc = _controls(qt)
    pcof, tgt = _inputs(qt.total_control_parameters(tc))
    (j1, guard, ridge), grad = qt.objective_and_gradient(
        tprob, tc, pcof, tgt, 4, ridge_penalty_strength=1e-3)
    assert grad.shape == pcof.shape and grad.dtype == torch.float64
    ref = _jax_f64_reference(solver, pcof, tgt)
    for s in range(S):
        (jj1, jg, jr), jgrad = ref[s]
        assert _rel(j1[s], jj1) <= tol_obj
        assert _rel(guard[s], jg) <= tol_obj
        assert _rel(ridge[s], jr) <= 1e-14
        assert _rel(grad[s], jgrad) <= tol_grad


@pytest.mark.parametrize("solver", ["lu", "schulz"])
def test_autograd_through_the_step_loop_matches_lagrange(solver):
    """discrete_adjoint(method="ad") differentiates the whole forward by
    autograd; "lagrange" is the hand-structured adjoint. float64."""
    _, tprob = _cnot3(solver, "float64")
    tc = _controls(qt)
    pcof, tgt = _inputs(qt.total_control_parameters(tc))
    g_ad = qt.discrete_adjoint(tprob, tc, pcof, tgt, 4, method="ad")
    g_la = qt.discrete_adjoint(tprob, tc, pcof, tgt, 4, method="lagrange")
    assert _rel(g_ad, g_la) <= 1e-12
    # a 1-D control vector gives the same gradient without a batch dim
    g1 = qt.discrete_adjoint(tprob, tc, pcof[1], tgt, 4)
    assert g1.shape == pcof[1].shape
    assert _rel(g1, g_la[1]) <= 1e-14
    if solver == "schulz":
        g_seg = qt.discrete_adjoint(tprob, tc, pcof, tgt, 4,
                                    method="segmented")
        assert _rel(g_seg, g_la) <= 1e-11


def test_in_step_stage_branch_matches_hoisted():
    """A hoisting cap exceeded (here by hoist_batch_hint) builds every
    stage inside the step loop: same results, float64."""
    tc = _controls(qt)
    pcof, tgt = _inputs(qt.total_control_parameters(tc))
    for solver in ("lu", "schulz"):
        _, tprob = _cnot3(solver, "float64")
        (j1, g, _), grad = qt.objective_and_gradient(tprob, tc, pcof, tgt, 4)
        capped = dataclasses.replace(tprob, hoist_batch_hint=10 ** 9)
        with pytest.warns(UserWarning, match="hoisted stage precompute"):
            (j1c, gc, _), gradc = qt.objective_and_gradient(capped, tc, pcof,
                                                            tgt, 4)
        assert _rel(j1c, j1) <= 1e-13 and _rel(gc, g) <= 1e-13
        assert _rel(gradc, grad) <= 1e-12


def test_segmented_objective_value_matches_jax():
    jprob, tprob = _cnot3("schulz", "float64")
    jprob = dataclasses.replace(jprob, schulz_iters=48, schulz_warm_budget=0)
    tprob = dataclasses.replace(tprob, schulz_iters=48, schulz_warm_budget=0)
    jc, tc = _controls(qgd_tpu), _controls(qt)
    pcof, tgt = _inputs(qt.total_control_parameters(tc))
    val = qt.segmented_objective_value(tprob, tc, pcof, tgt, 4,
                                       ridge_penalty_strength=1e-3)
    (j1, g, r), _ = qt.segmented_objective_and_gradient(
        tprob, tc, pcof, tgt, 4, ridge_penalty_strength=1e-3)
    assert torch.equal(val, j1 + g + r)
    for s in range(S):
        ref = j_seg_value(jprob, jc, jnp.asarray(pcof[s]), tgt, 4,
                          ridge_penalty_strength=1e-3, n_segments=NSTEPS)
        assert _rel(val[s], ref) <= 1e-11
    assert _rel(qt.segmented_gradient(tprob, tc, pcof[0], tgt, 4),
                qt.segmented_objective_and_gradient(tprob, tc, pcof[0], tgt,
                                                    4)[1]) == 0.0


def _small(nsteps=8):
    """Two transmons (3, 2) with essential levels (2, 2): one guard level,
    2N = 12, 4 gate columns."""
    freqs = 2 * np.pi * np.array([4.1, 4.8])
    kerr = 2 * np.pi * np.array([[0.22, 0.01], [0.01, 0.23]])
    args = ((3, 2), (2, 2), freqs, freqs, kerr, 4.0, nsteps)
    jprob = qgd_tpu.models.DispersiveProblem(*args)
    tprob = qt.models.DispersiveProblem(*args, device="cpu")
    jc = tuple(qgd_tpu.BSpline2Control(4, 4.0) for _ in range(2))
    tc = tuple(qt.BSpline2Control(4, 4.0) for _ in range(2))
    pcof = np.random.default_rng(3).standard_normal(16) * 0.3
    return jprob, jc, tprob, tc, pcof


def test_forward_histories_match_jax():
    """Order 6: thinned history with its derivative columns, the
    complex history, and a forced propagation (forcing takes the in-step
    branch)."""
    jprob, jc, tprob, tc, pcof = _small()
    kw = dict(save_every=2, return_derivatives=True)
    ours = qt.eval_forward(tprob, tc, pcof, 6, **kw)
    ref = jf.eval_forward(jprob, jc, jnp.asarray(pcof), 6, **kw)
    assert ours.shape == ref.shape == (5, 4, 12, 4)
    assert _rel(ours, ref) <= 1e-13
    cplx = qt.eval_forward_complex(tprob, tc, pcof, 6).numpy()
    ref = np.asarray(jf.eval_forward_complex(jprob, jc, jnp.asarray(pcof),
                                             6))
    assert np.iscomplexobj(cplx) and cplx.shape == ref.shape == (9, 6, 4)
    assert np.abs(cplx - ref).max() <= 1e-13 * np.abs(ref).max()
    forcing = np.random.default_rng(5).standard_normal((9, 3, 12, 4)) * 0.1
    ours = qt.eval_forward(tprob, tc, pcof, 6, forcing=forcing)
    ref = jf.eval_forward(jprob, jc, jnp.asarray(pcof), 6,
                          forcing=jnp.asarray(forcing))
    assert _rel(ours, ref) <= 1e-13


def test_adjoint_sweep_and_terminal_condition_match_jax():
    jprob, jc, tprob, tc, pcof = _small()
    rng = np.random.default_rng(6)
    tgt = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    final = rng.standard_normal((12, 4))
    forcing = rng.standard_normal((9, 12, 4)) * 0.1
    lam_N = qt.compute_terminal_condition(tprob, tc, pcof, tgt, final, 4)
    ref_N = ja.compute_terminal_condition(jprob, jc, jnp.asarray(pcof), tgt,
                                          jnp.asarray(final), 4)
    assert _rel(lam_N, ref_N) <= 1e-13
    ours = qt.eval_adjoint(tprob, tc, pcof, lam_N, 4, forcing=forcing)
    ref = jf.eval_adjoint(jprob, jc, jnp.asarray(pcof), ref_N, 4,
                          forcing=jnp.asarray(forcing))
    assert ours.shape == (9, 12, 4)
    assert _rel(ours, ref) <= 1e-13
    hist = qt.eval_forward(tprob, tc, pcof, 4)
    assert _rel(qt.compute_guard_forcing(tprob, hist),
                ja.compute_guard_forcing(jprob, jnp.asarray(hist.numpy()))
                ) <= 1e-14


def test_objective_api_matches_jax():
    jprob, jc, tprob, tc, pcof = _small()
    rng = np.random.default_rng(7)
    tgt = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    parts = qt.objective_parts(tprob, tc, pcof, tgt, 4,
                               ridge_penalty_strength=1e-2)
    ref = jo.objective_parts(jprob, jc, jnp.asarray(pcof), tgt, 4,
                             ridge_penalty_strength=1e-2)
    for a, b in zip(parts, ref):
        assert _rel(a, b) <= 1e-12
    assert _rel(qt.objective_value(tprob, tc, pcof, tgt, 4, 1e-2),
                jo.objective_value(jprob, jc, jnp.asarray(pcof), tgt, 4,
                                   1e-2)) <= 1e-12
    assert _rel(qt.infidelity_plus_guard(tprob, tc, pcof, tgt, 4),
                jo.infidelity_plus_guard(jprob, jc, jnp.asarray(pcof), tgt,
                                         4)) <= 1e-12
    assert _rel(infidelity_of(tprob, tc, pcof, tgt, 4),
                jo.infidelity_of(jprob, jc, jnp.asarray(pcof), tgt, 4)
                ) <= 1e-12
    assert default_adjoint_method() == ja.default_adjoint_method()
    psi = rng.standard_normal((5, 6, 4)) + 1j * rng.standard_normal((5, 6, 4))
    W = np.array(jprob.guard_subspace_projector)
    assert _rel(qt.guard_penalty(torch.tensor(psi), 0.5, 3.0, W),
                jo.guard_penalty(jnp.asarray(psi), 0.5, 3.0,
                                 jnp.asarray(W))) <= 1e-14
    assert _rel(qt.infidelity(torch.tensor(psi[0]), tgt, 4),
                jo.infidelity(jnp.asarray(psi[0]), jnp.asarray(tgt), 4)
                ) <= 1e-14
