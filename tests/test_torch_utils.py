"""The port's utilities, Juqbox interchange, Stormer-Verlet baseline,
sampling helpers and public names against the JAX package's, on the CPU
in float64 (as ``tests/test_utils_extra.py``, ``tests/test_juqbox_io.py``
and ``tests/test_juqbox_verlet.py`` hold the JAX package).

Tolerances: the state helpers, timestep estimates, Juqbox conversion and
the pure-numpy Richardson arithmetic compute the same float64 operations
as JAX, so they agree to roundoff (1e-14); the Verlet and Hermite
histories come from long float64 recursions in two libraries (1e-12).
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
import qgd_tpu.models.juqbox_io as jio  # noqa: E402
import qgd_tpu.models.juqbox_verlet as jverlet  # noqa: E402
import qgd_tpu.utils.richardson as jrich  # noqa: E402
import qgd_tpu_torch as qt  # noqa: E402
from qgd_tpu_torch.models import juqbox_verlet as tverlet  # noqa: E402
from qgd_tpu_torch.utils import ode_check, plotting  # noqa: E402

torch.set_num_threads(1)

RFQ = dict(tf=2.0, nsteps=30, detuning_frequency=0.3,
           self_kerr_coefficient=0.1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _juqbox_params():
    prob = qgd_tpu.models.rotating_frame_qubit(2, 1, **RFQ)
    H = np.asarray(prob.system_sym) + 1j * np.asarray(prob.system_asym)
    return dict(Hconst=H,
                Hsym_ops=[np.asarray(op) for op in prob.sym_operators],
                Hanti_ops=[np.asarray(op) for op in prob.asym_operators],
                Uinit=np.asarray(prob.u0) + 0j, T=2.0, nsteps=30, N=2,
                wmat_real=np.diag([0.0, 0.0, 1.0]))


def _case_states():
    rng = np.random.default_rng(0)
    psi = rng.standard_normal((4, 2)) + 1j * rng.standard_normal((4, 2))
    pairs = [(qt.complex_to_real(psi), qgd_tpu.complex_to_real(psi)),
             (qt.real_to_complex(qt.complex_to_real(psi)), psi),
             (qt.real_to_complex(psi.real, psi.imag), psi),
             (qt.target_helper(psi, N_guard_levels=2),
              qgd_tpu.target_helper(psi, N_guard_levels=2)),
             (qt.target_helper(psi[:, 0]), qgd_tpu.target_helper(psi[:, 0]))]
    pairs += list(zip(qt.initial_basis(3, 2), qgd_tpu.initial_basis(3, 2)))
    hist = rng.standard_normal((5, 3, 8, 2))          # (T, m+1, 2N, B)
    pairs += [(qt.get_populations(hist), qgd_tpu.get_populations(hist)),
              (qt.get_populations(hist[:, 0]),
               qgd_tpu.get_populations(hist[:, 0]))]
    return pairs, 1e-15


def _case_timestep():
    jprob = qgd_tpu.models.cnot3_problem(nsteps=100)
    prob = qt.cnot3_problem(nsteps=100, device="cpu")
    amps = [0.02, 0.03, 0.01]
    jrab = qgd_tpu.construct_rabi_prob(tf=10.0, nsteps=8)
    rab = qt.construct_rabi_prob(tf=10.0, nsteps=8, device="cpu")
    pairs = [(qt.get_shortest_period(prob, amps),
              qgd_tpu.get_shortest_period(jprob, amps)),
             (qt.estimate_N_timesteps(prob, amps),
              qgd_tpu.estimate_N_timesteps(jprob, amps)),
             (qt.estimate_N_timesteps(prob, amps, 7),
              qgd_tpu.estimate_N_timesteps(jprob, amps, 7)),
             (qt.estimate_timesteps_per_period(rab, [0.3], 4, [1.0, 2.0]),
              qgd_tpu.estimate_timesteps_per_period(jrab, [0.3], 4,
                                                    [1.0, 2.0]))]
    return pairs, 1e-12


def _case_juqbox_io(tmp_path):
    params = _juqbox_params()
    prob = qt.convert_juqbox(params, device="cpu")
    jprob = jio.convert_juqbox(params)
    pairs = [(getattr(prob, f), getattr(jprob, f)) for f in (
        "system_sym", "system_asym", "sym_operators", "asym_operators", "u0",
        "v0", "guard_subspace_projector")]
    pairs += [((prob.tf, prob.nsteps, prob.N_ess_levels),
               (jprob.tf, jprob.nsteps, jprob.N_ess_levels))]
    flat = {k: params[k] for k in ("Hconst", "Uinit", "wmat_real", "T",
                                   "nsteps", "N")}
    for key in ("Hsym_ops", "Hanti_ops"):
        flat.update({f"{key}_{i}": op for i, op in enumerate(params[key])})
    np.savez(tmp_path / "juq.npz", **flat)
    loaded = qt.load_juqbox_npz(str(tmp_path / "juq.npz"), device="cpu")
    pairs += [(loaded.u0, prob.u0), (loaded.guard_subspace_projector,
                                     prob.guard_subspace_projector)]
    kw = dict(Ne=[2], Ng=[1], Cfreq=[[0.0]], nCoeff=10,
              target_complex=np.eye(3)[:, :2])
    out, jout = qt.convert_to_juqbox(prob, **kw), jio.convert_to_juqbox(
        jprob, **kw)
    assert sorted(out) == sorted(jout)
    for k in out:
        if k == "Rfreq":
            assert np.isnan(out[k]).all() and out[k].shape == jout[k].shape
        elif k in ("Hsym_ops", "Hanti_ops"):
            pairs += list(zip(out[k], jout[k]))
        else:
            pairs.append((out[k], jout[k]))
    with pytest.raises(ValueError):
        qt.convert_juqbox(dict(params, Hunc_ops=[np.eye(3)]), device="cpu")
    return pairs, 0.0


def _case_sampling():
    rng = np.random.default_rng(5)
    pcof = rng.uniform(-0.5, 0.5, 16)
    ctrls = [qt.BSpline2Control(4, 2.0), qt.BSpline2Control(4, 2.0)]
    jctrls = [qgd_tpu.BSpline2Control(4, 2.0)] * 2
    new, pc = qt.sample_from_controls(ctrls, pcof, 5, 2)
    jnew, jpc = qgd_tpu.sample_from_controls(jctrls, jnp.asarray(pcof), 5, 2)
    assert [c.N_coeff for c in new] == [c.N_coeff for c in jnew]
    hc = qt.HermiteControl(5, 2.0, 3)
    jhc = qgd_tpu.HermiteControl(5, 2.0, 3)
    one = qt.construct_pcof_from_sample(ctrls[0], pcof[:8], hc)
    jone = qgd_tpu.construct_pcof_from_sample(jctrls[0],
                                              jnp.asarray(pcof[:8]), jhc)
    return [(pc, jpc), (one, jone)], 1e-14


def _case_exports():
    """Every public name of the JAX package (top level, models, parallel,
    utils) has its twin in the port."""
    import qgd_tpu.parallel

    for jmod, tmod in ((qgd_tpu, qt), (qgd_tpu.models, qt.models),
                       (qgd_tpu.parallel, qt.parallel),
                       (qgd_tpu.utils, qt.utils)):
        missing = set(jmod.__all__) - set(tmod.__all__)
        assert missing == set(), missing
        assert all(hasattr(tmod, n) for n in tmod.__all__)
    return [], 0.0


@pytest.mark.parametrize("case", ["states", "timestep", "juqbox_io",
                                  "sampling", "exports"])
def test_helpers_match_jax(case, tmp_path):
    """State helpers, timestep estimates, the Juqbox conversion both ways
    (and through npz) and the Hermite sampling helpers, through the port's
    top-level names, against the JAX package's."""
    cases = {"states": _case_states, "timestep": _case_timestep,
                "juqbox_io": lambda: _case_juqbox_io(tmp_path),
                "sampling": _case_sampling, "exports": _case_exports}
    pairs, tol = cases[case]()
    for got, ref in pairs:
        got, ref = _np(got), _np(ref)
        assert got.shape == ref.shape, (got.shape, ref.shape)
        assert np.abs(got - ref).max(initial=0.0) <= tol


@pytest.fixture(scope="module")
def rand_setup():
    """tests/test_juqbox_verlet.py's problem: 8 levels, 2 controls."""
    rng = np.random.default_rng(0)
    pcof = rng.uniform(-0.5, 0.5, 24)
    jprob = qgd_tpu.models.construct_rand_prob(8, 2, tf=2.0, nsteps=64,
                                               seed=3)
    prob = qt.construct_rand_prob(8, 2, tf=2.0, nsteps=64, seed=3,
                                  device="cpu")
    return (prob, tuple(qt.BSpline2Control(6, 2.0) for _ in range(2)),
            jprob, tuple(qgd_tpu.BSpline2Control(6, 2.0) for _ in range(2)),
            pcof)


def test_richardson_and_verlet_match_jax(rand_setup, tmp_path):
    """get_histories (orders 2 and 4, 3 refinements, the JSON + npz dump)
    and verlet_forward (whole; thinned against whole) against the JAX
    package's, verlet_histories' sweep, and the runtime ratio of the two
    sweeps end to end."""
    prob, ctrls, jprob, jctrls, pcof = rand_setup
    base = str(tmp_path / "sweep")
    ours = qt.get_histories(prob, ctrls, pcof, 3, orders=(2, 4),
                            base_nsteps=16, verbose=False,
                            jld2_filename=base)
    ref = jrich.get_histories(jprob, jctrls, jnp.asarray(pcof), 3,
                              orders=(2, 4), base_nsteps=16, verbose=False)
    assert list(ours) == list(ref) == ["Order 2", "Order 4"]
    for key in ours:
        assert ours[key]["nsteps"] == ref[key]["nsteps"] == [16, 32, 64]
        for h, jh in zip(ours[key]["histories"], ref[key]["histories"]):
            assert h.shape == jh.shape == (17, 16, 8)
            assert np.abs(h - np.asarray(jh)).max() <= 1e-12
        np.testing.assert_allclose(ours[key]["rel_errs"],
                                   ref[key]["rel_errs"], rtol=1e-8)
    # the errors fall at the order: about 2^order per halving of dt
    slope = np.log2(ours["Order 4"]["rel_errs"][0]
                    / ours["Order 4"]["rel_errs"][1])
    assert abs(slope - 4.0) < 0.5, slope
    meta = json.loads((tmp_path / "sweep.json").read_text())
    assert meta["Order 4"]["nsteps"] == [16, 32, 64]
    with np.load(base + ".npz") as npz:
        assert sorted(npz.files) == sorted(
            f"Order {o}/history_{i}" for o in (2, 4) for i in range(3))

    h = tverlet.verlet_forward(prob, ctrls, pcof)
    jh = jverlet.verlet_forward(jprob, jctrls, jnp.asarray(pcof))
    assert h.dtype == torch.float64 and h.shape == jh.shape == (65, 16, 8)
    assert np.abs(_np(h) - jh).max() <= 1e-12
    p2 = qt.construct_rand_prob(8, 2, tf=2.0, nsteps=128, seed=3,
                                device="cpu")
    thin = tverlet.verlet_forward(p2, ctrls, pcof, save_every=2)
    assert thin.shape == h.shape
    assert float((thin - h).norm() / h.norm()) < 0.1
    # the sweep's entries are verlet_forward's (held against JAX above)
    verlet = tverlet.verlet_histories(prob, ctrls, pcof, 4, base_nsteps=16,
                                      verbose=False)
    entry = verlet["Verlet order 2"]
    assert entry["nsteps"] == [16, 32, 64, 128]
    np.testing.assert_array_equal(entry["histories"][2], _np(h)[::4])
    assert len(entry["rel_errs"]) == 3 and np.all(
        np.diff(np.log2(entry["rel_errs"])) < -1.5)
    # a target inside the order-4 sweep; the Verlet sweep's last segment
    # extends to it where it stops short
    target = float(np.sqrt(np.prod(ours["Order 4"]["rel_errs"])))
    ratios = qt.get_runtime_ratios(ours, verlet, target_error=target,
                                   extrapolate=True)
    assert ratios["Order 4"] is not None and ratios["Order 4"] > 0


def test_ode_check_and_plots():
    """The scipy DOP853 ground truth (the RHS through the port's control
    tables and generator stack) against the Hermite propagator, as
    tests/test_utils_extra.py holds JAX's; QuTiP's bridge raises
    ImportError where QuTiP is absent; the plots draw headless."""
    prob = qt.rotating_frame_qubit(3, 1, tf=1.0, nsteps=200,
                                   detuning_frequency=0.4,
                                   self_kerr_coefficient=0.2, device="cpu")
    ctrl = qt.BSpline2Control(4, 1.0)
    pcof = np.linspace(-0.3, 0.4, 8)
    assert ode_check.test_agreement(prob, ctrl, pcof, order=6,
                                    rtol=1e-12) < 1e-9
    try:
        import qutip  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            ode_check.simulate_prob_no_control(prob)
    pytest.importorskip("matplotlib")
    hist = qt.eval_forward(prob, ctrl, pcof, 4)
    figs = [plotting.plot_populations(hist), plotting.plot_states(hist),
            plotting.plot_controls(ctrl, pcof),
            plotting.plot_control_basis_functions(ctrl)]
    assert all(f.axes for f in figs)
    pops = qt.get_populations(hist)
    assert torch.allclose(pops.sum(dim=1), torch.ones(201, 3,
                                                      dtype=torch.float64),
                          atol=1e-10)
