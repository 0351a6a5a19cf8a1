"""Setups and histories cross between the packages: files written by
qgd_tpu load in qgd_tpu_torch and give the same objective, and the
reverse, for every control family; resume_optimization continues the
count; the f64 verification pass; a GMRES setup carries its settings
over; a setup the port cannot run raises.

Tolerance: objectives of a loaded setup relative <= 1e-12 against the
other package's, with an absolute floor of 1e-14 (float64, the same
problem arrays bit for bit; the infidelity ``1 - |tr|^2/N^2`` is formed
from a number near 1, so the two propagations' ~1e-15 roundoff shows there
in absolute terms).
"""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
from qgd_tpu import checkpoint as jck  # noqa: E402
import qgd_tpu_torch as qt  # noqa: E402

torch.set_num_threads(1)

SWAP = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=np.complex128)


def _mixed_controls(pkg, tf):
    return (pkg.CarrierControl(pkg.BSpline2Control(4, tf), [1.1, -0.3]),
            pkg.GRAPEControl(3, tf))


def test_jax_files_load_in_the_port(tmp_path):
    """A JAX optimization's setup and history, and a JAX setup with carrier
    and GRAPE controls on CNOT2, read by the port."""
    base = str(tmp_path / "jax_run")
    jprob = qgd_tpu.construct_rabi_prob(nsteps=20)
    jh = qgd_tpu.optimize_gate(
        jprob, qgd_tpu.GRAPEControl(1, float(jprob.tf)),
        jnp.array([0.4, 0.1]), SWAP, order=4, maxIter=3, print_level=0,
        filename=base)
    hist = qt.OptimizationHistory.load(base)
    assert hist.obj_value == jh.obj_value and hist.iter_count == jh.iter_count
    np.testing.assert_array_equal(np.asarray(hist.pcof),
                                  np.asarray(jh.pcof))
    setup = qt.load_setup(base, device="cpu")
    assert setup["order"] == 4 and setup["maxIter"] == 3
    assert setup["prob"].device.type == "cpu"
    ours = qt.objective_value(setup["prob"], setup["controls"], hist.pcof[-1],
                              setup["target"], 4, 1e-2)
    np.testing.assert_allclose(float(ours), jh.analytic_obj_value[-1],
                               rtol=1e-12, atol=1e-14)

    cbase = str(tmp_path / "jax_setup")
    jprob = qgd_tpu.models.cnot2_problem(tf=4.0, nsteps=8)
    jc = _mixed_controls(qgd_tpu, 4.0)
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    jck.save_setup(cbase, jprob, jc, tgt, order=6, pcof_L=-0.5,
                   pcof_U=np.full(22, 0.5), ridge_penalty_strength=3e-3,
                   maxIter=17)
    s = qt.load_setup(cbase, device="cpu")
    assert s["maxIter"] == 17 and s["pcof_L"] == -0.5
    np.testing.assert_array_equal(s["pcof_U"], np.full(22, 0.5))
    assert [type(c).__name__ for c in s["controls"]] == ["_Carrier", "_GRAPE"]
    pcof = rng.standard_normal(22) * 0.1
    np.testing.assert_allclose(
        float(qt.objective_value(s["prob"], s["controls"], pcof, s["target"],
                                 6, 3e-3)),
        float(qgd_tpu.objective_value(jprob, jc, jnp.asarray(pcof), tgt, 6,
                                      3e-3)), rtol=1e-12, atol=1e-14)


def test_port_files_load_in_jax(tmp_path):
    base = str(tmp_path / "port_run")
    tprob = qt.models.cnot2_problem(tf=4.0, nsteps=8, device="cpu",
                                    solver="schulz")
    tc = _mixed_controls(qt, 4.0)
    rng = np.random.default_rng(2)
    tgt = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    th = qt.optimize_gate(tprob, tc, rng.standard_normal(22) * 0.1, tgt,
                          order=4, maxIter=2, pcof_L=-1.0, pcof_U=1.0,
                          print_level=0, filename=base)
    s = jck.load_setup(base)
    assert s["prob"].solver == "schulz" and s["prob"].nsteps == 8
    assert [type(c).__name__ for c in s["controls"]] == ["_Carrier", "_GRAPE"]
    jh = qgd_tpu.OptimizationHistory.load(base)
    assert jh.obj_value == th.obj_value
    ref = qgd_tpu.objective_value(s["prob"], s["controls"],
                                  jnp.asarray(jh.pcof[-1]), s["target"], 4,
                                  s["ridge_penalty_strength"])
    np.testing.assert_allclose(float(ref), th.obj_value[-1], rtol=1e-12,
                               atol=1e-14)


def test_resume_continues_the_count(tmp_path):
    base = str(tmp_path / "run")
    tprob = qt.construct_rabi_prob(nsteps=40, device="cpu")
    h1 = qt.optimize_gate(tprob, qt.GRAPEControl(1, tprob.tf),
                          np.array([0.4, 0.1]), SWAP, order=4, maxIter=3,
                          ridge_penalty_strength=0.0, print_level=0,
                          filename=base)
    n1 = len(h1.obj_value)
    h2 = qt.resume_optimization(base, device="cpu", maxIter=3, print_level=0)
    assert len(h2.obj_value) > n1
    assert h2.iter_count == list(range(len(h2.obj_value)))
    assert h2.obj_value[-1] <= h1.obj_value[0]
    np.testing.assert_array_equal(h2.pcof[n1], h1.pcof[-1])
    assert qt.OptimizationHistory.load(base).obj_value == h2.obj_value


def test_verify_history_f64_and_unported_setups(tmp_path):
    base = str(tmp_path / "f32")
    tprob = qt.models.cnot2_problem(tf=4.0, nsteps=8, device="cpu",
                                    dtype="float32")
    tc = tuple(qt.BSpline2Control(4, 4.0) for _ in range(2))
    rng = np.random.default_rng(3)
    tgt = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    qt.optimize_gate(tprob, tc, rng.standard_normal(16) * 0.05, tgt, order=4,
                     maxIter=2, filename=base, print_level=0)
    rec = qt.verify_history_f64(base, which="best", device="cpu")
    assert abs(rec["delta_objective"]) < 1e-5
    with open(base + ".f64check.json") as f:
        assert json.load(f)["f64_objective"] == rec["f64_objective"]

    gmres = dict(solver="gmres", gmres_iters=12, gmres_abstol=1e-9,
                 gmres_reltol=1e-8, preconditioner_type="diagonal")
    jprob = dataclasses.replace(
        qgd_tpu.models.cnot2_problem(tf=4.0, nsteps=8), **gmres)
    jck.save_setup(str(tmp_path / "gmres"), jprob,
                   qgd_tpu.BSpline2Control(4, 4.0), tgt)
    loaded = qt.load_setup(str(tmp_path / "gmres"), device="cpu")
    assert {k: getattr(loaded["prob"], k) for k in gmres} == gmres
    qt.save_setup(str(tmp_path / "gmres_back"), loaded["prob"],
                  loaded["controls"], tgt)
    back = jck.load_setup(str(tmp_path / "gmres_back"))["prob"]
    assert {k: getattr(back, k) for k in gmres} == gmres
    lprob = qt.models.cnot2_problem(tf=4.0, nsteps=8, device="cpu")
    pc = rng.standard_normal(8) * 0.05
    val = qt.objective_value(loaded["prob"], loaded["controls"], pc, tgt, 4)
    ref = qt.objective_value(lprob, loaded["controls"], pc, tgt, 4)
    assert abs(float(val) - float(ref)) <= 1e-12 * abs(float(ref)) + 1e-14
    jck.save_setup(str(tmp_path / "hermite"), qgd_tpu.models.cnot2_problem(
        nsteps=8), qgd_tpu.HermiteControl(4, 2.0, 2), tgt)
    loaded = qt.load_setup(str(tmp_path / "hermite"), device="cpu")
    assert type(loaded["controls"][0]).__name__ == "_Hermite"


def _every_family(pkg, tf):
    """One control of every family the JAX package has, nested ones too."""
    return (pkg.SinCosControl(tf, 1.3), pkg.SinControl(tf, 0.7),
            pkg.CosControl(tf, 2.0), pkg.SquaredAmpCosControl(tf, 1.1),
            pkg.SingleSymCosControl(tf, 0.9), pkg.ZeroControl(tf, 0),
            pkg.GeneralBSplineControl(2, 4, tf),
            pkg.FortranBSplineControl(3, 6, tf), pkg.HermiteControl(3, tf, 1),
            pkg.HermiteCarrierControl(3, tf, 1, [0.4, -0.9]),
            pkg.BSplineControl(tf, 4, [0.3]),
            pkg.GeneralGRAPEControl(2, tf, 1))


def test_every_control_family_round_trips_both_ways(tmp_path):
    """Setups with one control of every family, written by either package,
    load in the other with the same class names and the same tables."""
    tf, m = 2.0, 3
    rng = np.random.default_rng(4)
    tgt = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    jprob = qgd_tpu.construct_rabi_prob(nsteps=8)
    tprob = qt.construct_rabi_prob(nsteps=8, device="cpu")
    jc, tc = _every_family(qgd_tpu, tf), _every_family(qt, tf)
    jck.save_setup(str(tmp_path / "j"), jprob, jc, tgt)
    qt.save_setup(str(tmp_path / "t"), tprob, tc, tgt)
    from_jax = qt.load_setup(str(tmp_path / "j"), device="cpu")["controls"]
    from_port = jck.load_setup(str(tmp_path / "t"))["controls"]
    names = [type(c).__name__ for c in jc]
    assert [type(c).__name__ for c in from_jax] == names
    assert [type(c).__name__ for c in from_port] == names
    n = qt.total_control_parameters(tc)
    pcof = rng.standard_normal(n) * 0.3
    ts = np.linspace(0.0, tf, 9)
    from qgd_tpu.controls import control_tables as j_tables

    tables = jax.jit(lambda c, p: j_tables(c, p, jnp.asarray(ts), m))
    ref = tables(jc, jnp.asarray(pcof))
    for ours in (qt.control_tables(from_jax, torch.tensor(pcof), ts, m),
                 tables(from_port, jnp.asarray(pcof))):
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-14, atol=1e-14)
