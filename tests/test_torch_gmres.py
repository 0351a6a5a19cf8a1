"""The matrix-free GMRES route of qgd_tpu_torch against qgd_tpu on the CPU:
the batched solver itself, the three preconditioners, the forward history,
the Lagrange and autograd gradients, the segmented, thinned, prefix and
optimizer routes on a GMRES problem, and the residual diagnostic.

Tolerances (float64): the solver against JAX's on a dense 24 x 24 system
and past a breakdown (Krylov space exhausted before the budget) <= 1e-12
absolute; GMRES histories against JAX's <= 1e-12 and against the port's
LU history <= 1e-10; the Rabi gradient (8 Arnoldi steps, 2N = 4) by
Lagrange and by autograd against JAX's <= 1e-11 relative; the
preconditioners invert the drift-only stage matrix <= 1e-10; segmented
against plain <= 1e-12 relative. Every case is converged GMRES, so what
separates the packages is roundoff; a wrong term shows at 1e-3 or more.
"""

import dataclasses
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
from qgd_tpu.ops import gmres as jgm  # noqa: E402
from qgd_tpu.ops import preconditioners as jpc  # noqa: E402
import qgd_tpu_torch as qt  # noqa: E402
from qgd_tpu_torch.ops import gmres as tgm  # noqa: E402
from qgd_tpu_torch.ops import preconditioners as tpc  # noqa: E402
from qgd_tpu_torch.ops import stage_kernels as sk  # noqa: E402

torch.set_num_threads(1)

RFQ = dict(tf=1.0, nsteps=20, detuning_frequency=0.4,
           self_kerr_coefficient=0.2)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _stage_system(prob_t, pcof, seed):
    """The implicit stage operator of the first step of a problem, as a
    dense matrix (numpy), and three right-hand sides."""
    m = 2
    dt = float(prob_t.tf) / prob_t.nsteps
    P, Q = qt.control_tables(qt.BSpline2Control(4, prob_t.tf),
                             torch.tensor(pcof), torch.tensor([dt]), m)
    A = qt.assemble_generator_stack(prob_t, P[0], Q[0], m)
    eye = torch.eye(prob_t.real_system_size, dtype=torch.float64)
    M = qt.build_lhs(qt.scaled_derivatives(A, eye, m), dt, m).numpy()
    rng = np.random.default_rng(seed)
    return M, rng.standard_normal((M.shape[0], 3))


def _dense_24():
    rng = np.random.default_rng(0)
    A = np.eye(24) + 0.1 * rng.standard_normal((24, 24))
    return A, rng.standard_normal((24, 3))


def _rfq_stage():
    pcof = np.random.default_rng(1).standard_normal(8) * 0.2
    return _stage_system(qt.rotating_frame_qubit(3, 1, device="cpu", **RFQ),
                         pcof, 5)


def _rabi_stage():
    pcof = np.random.default_rng(2).standard_normal(8) * 0.3
    return _stage_system(qt.construct_rabi_prob(nsteps=15, device="cpu"),
                         pcof, 6)


@pytest.mark.parametrize("system,iters", [
    (_dense_24, 24),        # the JAX package's own case
    (_dense_24, 30),        # breakdown: 30 steps in a 24-dim space
    (_rfq_stage, 25),       # rotating_frame_qubit(3, 1): 2N = 8, 25 steps
    (_rabi_stage, 8),       # the Rabi gradient's stage: 2N = 4, 8 steps
], ids=["dense24", "dense24-breakdown", "rfq-breakdown", "rabi-breakdown"])
def test_gmres_solve_matches_jax(system, iters):
    A, B = system()
    X0 = np.zeros_like(B)
    ref = np.asarray(jgm.gmres_solve(lambda v: jnp.asarray(A) @ v,
                                     jnp.asarray(B), jnp.asarray(X0),
                                     iters=iters))
    At = torch.tensor(A)
    X = tgm.gmres_solve(lambda v: At @ v, torch.tensor(B)[None],
                        torch.tensor(X0)[None], iters=iters)[0].numpy()
    assert np.abs(X - ref).max() <= 1e-12
    assert np.abs(A @ X - B).max() <= 1e-12
    x1 = tgm.gmres_solve_single(lambda v: At @ v, torch.tensor(B[:, 1]),
                                torch.zeros(A.shape[0], dtype=torch.float64),
                                iters=iters).numpy()
    assert np.abs(x1 - ref[:, 1]).max() <= 1e-12


@pytest.fixture(scope="module")
def rfq_reference():
    """JAX's GMRES histories of rotating_frame_qubit(3, 1) (25 Arnoldi
    steps) for each preconditioner, compiled once."""
    base = qgd_tpu.models.rotating_frame_qubit(3, 1, **RFQ)
    pcof = np.random.default_rng(1).standard_normal(8) * 0.2
    ctrl = qgd_tpu.BSpline2Control(4, 1.0)
    out = {}
    for pc in ("identity", "lu", "diagonal"):
        jp = dataclasses.replace(base, solver="gmres", gmres_iters=25,
                                 preconditioner_type=pc)
        out[pc] = np.asarray(qgd_tpu.eval_forward(jp, ctrl,
                                                  jnp.asarray(pcof), 4))
    return pcof, out


@pytest.mark.parametrize("precond", ["identity", "lu", "diagonal"])
def test_gmres_forward_matches_jax_and_lu(rfq_reference, precond):
    pcof, ref = rfq_reference
    ctrl = qt.BSpline2Control(4, 1.0)
    gp = qt.rotating_frame_qubit(3, 1, device="cpu", solver="gmres",
                                 gmres_iters=25, preconditioner_type=precond,
                                 **RFQ)
    h = qt.eval_forward(gp, ctrl, pcof, 4).numpy()
    assert np.abs(h - ref[precond]).max() <= 1e-12
    h_lu = qt.eval_forward(qt.rotating_frame_qubit(3, 1, device="cpu",
                                                   **RFQ), ctrl, pcof, 4)
    assert np.abs(h - h_lu.numpy()).max() <= 1e-10
    # the thinned history is the strided slice of the whole one
    h5 = qt.eval_forward(gp, ctrl, pcof, 4, save_every=5).numpy()
    np.testing.assert_array_equal(h5, h[::5])


@pytest.fixture(scope="module")
def rabi_case():
    """The JAX package's GMRES gradient case: Rabi, 15 steps, 8 Arnoldi
    steps; JAX's Lagrange gradient, compiled once."""
    rng = np.random.default_rng(2)
    pcof = rng.standard_normal(8) * 0.3
    tgt = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    jp = dataclasses.replace(qgd_tpu.models.construct_rabi_prob(nsteps=15),
                             solver="gmres", gmres_iters=8)
    g = np.asarray(qgd_tpu.discrete_adjoint(
        jp, qgd_tpu.BSpline2Control(4, float(jp.tf)), jnp.asarray(pcof),
        tgt, 4))
    tp = qt.construct_rabi_prob(nsteps=15, device="cpu", solver="gmres",
                                gmres_iters=8)
    return tp, qt.BSpline2Control(4, tp.tf), pcof, tgt, g


@pytest.mark.parametrize("method", ["lagrange", "ad"])
def test_rabi_gradient_matches_jax(rabi_case, method):
    tp, ctrl, pcof, tgt, ref = rabi_case
    g = qt.discrete_adjoint(tp, ctrl, pcof, tgt, 4, method=method)
    assert _rel(g, ref) <= 1e-11


def test_forced_and_fd_gradients_on_gmres(rabi_case):
    """Forward mode through the GMRES stage (its tangent solve) and central
    differences agree with the adjoint (f64)."""
    tp, ctrl, pcof, tgt, ref = rabi_case
    g = qt.eval_grad_forced(tp, ctrl, pcof, tgt, 4).numpy()
    assert _rel(g, ref) <= 1e-12
    fd = qt.eval_grad_finite_difference(tp, ctrl, pcof, tgt, 4).numpy()
    assert _rel(fd, ref) <= 1e-8


def test_gmres_stage_autograd_gradcheck():
    """The stage solve's reverse rule (transposed GMRES + operator VJP) and
    forward rule (tangent solve) against finite differences, f64, at a
    budget that solves exactly (2N = 6, 6 steps)."""
    rng = np.random.default_rng(7)
    A = torch.tensor(rng.standard_normal((2, 2, 6, 6)) * 0.3,
                     requires_grad=True)
    B = torch.tensor(rng.standard_normal((2, 6, 3)), requires_grad=True)
    X0 = torch.tensor(rng.standard_normal((2, 6, 3)))
    f = lambda a, b: tgm.hermite_gmres_stage(a, b, X0, 0.2, 2, iters=6)
    assert torch.autograd.gradcheck(f, (A, B), check_forward_ad=True)


@pytest.mark.parametrize("factory", ["lu", "diagonal"])
def test_preconditioners_invert_no_control_lhs(factory):
    """Each preconditioner inverts the drift-only stage matrix, forward and
    transposed, on float64 and float32 vectors; the matrix is JAX's."""
    jprob = qgd_tpu.models.rotating_frame_qubit(3, 1, **dict(RFQ, nsteps=10))
    tprob = qt.rotating_frame_qubit(3, 1, device="cpu",
                                    **dict(RFQ, nsteps=10))
    dt = 0.1
    M = tpc.no_control_lhs(tprob, dt, 4).numpy()
    np.testing.assert_allclose(M, np.asarray(jpc.no_control_lhs(jprob, dt,
                                                                4)),
                               rtol=0, atol=1e-15)
    V = np.random.default_rng(3).standard_normal((2, M.shape[0], 2))
    apply, apply_T = tpc.PRECONDITIONERS[factory](tprob, dt, 4)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        v = torch.tensor(V, dtype=dtype)
        x, xT = apply(v), apply_T(v)
        assert x.dtype == xT.dtype == dtype
        assert np.abs(M @ x.double().numpy() - V).max() <= tol
        assert np.abs(M.T @ xT.double().numpy() - V).max() <= tol


@pytest.fixture(scope="module")
def rand_case():
    """construct_rand_prob(3, 2), 24 steps: a GMRES problem with the diagonal
    preconditioner beside its LU twin, two scenarios."""
    kw = dict(tf=2.0, nsteps=24, seed=7, device="cpu")
    gp = qt.construct_rand_prob(3, 2, solver="gmres",
                                preconditioner_type="diagonal", **kw)
    lp = qt.construct_rand_prob(3, 2, **kw)
    ctrl = tuple(qt.BSpline2Control(4, 2.0) for _ in range(2))
    rng = np.random.default_rng(0)
    pcof = rng.standard_normal((2, 16)) * 0.2
    tgt, _ = np.linalg.qr(rng.standard_normal((3, 3))
                          + 1j * rng.standard_normal((3, 3)))
    return gp, lp, ctrl, pcof, tgt


@pytest.mark.parametrize("n_segments", [24, 4])
def test_segmented_gmres_matches_plain(rand_case, n_segments):
    """L = 1 and L = 6: GMRES forward and re-forward, dense LU backward,
    against the plain Lagrange route of the same GMRES problem."""
    gp, lp, ctrl, pcof, tgt = rand_case
    kw = dict(ridge_penalty_strength=1e-3)
    (j1, g, _), grad = qt.segmented_objective_and_gradient(
        gp, ctrl, pcof, tgt, 4, n_segments=n_segments, **kw)
    (pj1, pg, pr), pgrad = qt.objective_and_gradient(gp, ctrl, pcof, tgt,
                                                     4, **kw)
    assert _rel(j1 + g, pj1 + pg) <= 1e-12
    assert _rel(grad, pgrad) <= 1e-12
    val = qt.segmented_objective_value(gp, ctrl, pcof, tgt, 4,
                                       n_segments=n_segments, **kw)
    assert _rel(val, pj1 + pg + pr) <= 1e-12


def test_prefix_and_optimizer_dispatch_on_gmres(rand_case):
    """The prefix route takes a GMRES problem as it takes an LU one (exact
    inverses in f64, Newton-Schulz in f32: the same numbers); optimize_gate
    on the GMRES problem follows the LU problem's iterates."""
    gp, lp, ctrl, pcof, tgt = rand_case
    for dtype in ("float64", "float32"):
        g_, l_ = (dataclasses.replace(p, dtype=dtype) for p in (gp, lp))
        (a, _, _), ga = qt.prefix_objective_and_gradient(g_, ctrl, pcof, tgt,
                                                         4, n_segments=4)
        (b, _, _), gb = qt.prefix_objective_and_gradient(l_, ctrl, pcof, tgt,
                                                         4, n_segments=4)
        assert torch.equal(a, b) and torch.equal(ga, gb)
    hg, hl = (qt.optimize_gate(p, ctrl, pcof[0], tgt, order=4, maxIter=3,
                               print_level=0) for p in (gp, lp))
    np.testing.assert_allclose(hg.obj_value, hl.obj_value, rtol=1e-10)
    assert hg.obj_value[-1] < hg.obj_value[0]


def test_f32_gmres_on_the_cpu_launches_nothing(rand_case):
    """float32 on the CPU: the operator runs the RHS kernel's plain version
    at step sign -1 and counts no launch; the route lies within f32
    roundoff of float64."""
    gp, lp, ctrl, pcof, tgt = rand_case
    sk.reset_launch_counts()
    h32 = qt.eval_forward(dataclasses.replace(gp, dtype="float32"), ctrl,
                          pcof, 4)
    assert h32.dtype == torch.float32
    assert sk.launch_counts() == {"hermite_lhs_matrix": 0, "hermite_rhs": 0,
                                  "hermite_stage_pair": 0}
    assert sk.rhs_launches_by_sign() == {"-1": 0, "+1": 0}
    h64 = qt.eval_forward(gp, ctrl, pcof, 4)
    assert float((h32.double() - h64).abs().max()) <= 1e-5


def test_stage_residuals_gmres_tolerance_warning(rand_case):
    """A starved budget trips the requested-tolerance warning (and its
    residual is JAX's); a healthy one stays quiet, as in
    tests/test_diagnostics.py."""
    gp, _, ctrl, pcof, _ = rand_case
    starved = dataclasses.replace(gp, gmres_iters=1, gmres_abstol=1e-12,
                                  gmres_reltol=1e-12,
                                  preconditioner_type="identity")
    with pytest.warns(UserWarning, match="exceeds requested tolerance"):
        d = qt.stage_residuals(starved, ctrl, pcof[0], order=6)
    jp = dataclasses.replace(
        qgd_tpu.models.construct_rand_prob(3, 2, tf=2.0, nsteps=24, seed=7),
        solver="gmres", gmres_iters=1, gmres_abstol=1e-12,
        gmres_reltol=1e-12)
    with pytest.warns(UserWarning):
        jd = qgd_tpu.stage_residuals(
            jp, tuple(qgd_tpu.BSpline2Control(4, 2.0) for _ in range(2)),
            jnp.asarray(pcof[0]), order=6)
    assert abs(d["max"] - jd["max"]) <= 1e-12 * jd["max"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        d = qt.stage_residuals(gp, ctrl, pcof, order=4)
    assert d["solver"] == "gmres" and d["max"] < 1e-10
