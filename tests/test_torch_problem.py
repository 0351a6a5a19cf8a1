"""qgd_tpu_torch problem container and builders against qgd_tpu.models:
the numpy builders are copies, so the arrays agree exactly."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
import qgd_tpu.models as jm  # noqa: E402
import qgd_tpu_torch as qt  # noqa: E402
import qgd_tpu_torch.models as tm  # noqa: E402

torch.set_num_threads(1)

SIZES, ESS = (4, 4, 4), (2, 2, 2)
_FIELDS = ("system_sym", "system_asym", "sym_operators", "asym_operators",
           "u0", "v0", "guard_subspace_projector")


@pytest.mark.parametrize("name,args", [
    ("lowering_operators_system", (SIZES,)),
    ("basis_state", (SIZES, (1, 0, 3))),
    ("create_initial_conditions", (SIZES, ESS)),
    ("guard_projector", (SIZES, ESS)),
    ("create_gate", (SIZES, ESS, [((1, 1, 0), (1, 0, 0))])),
    ("rotation_matrix", (SIZES, [1.3, 2.1, 0.7], 3.5)),
    ("multi_qudit_hamiltonian_dispersive",
     (SIZES, [1.0, 2.0, 3.0], [0.5, 1.5, 2.5],
      np.array([[0.1, 0.01, 0.02], [0.01, 0.2, 0.03], [0.02, 0.03, 0.3]]))),
    ("control_ops", (SIZES,)),
    ("cnot3_target", (550.0,)),
    ("lowering_operator", (5,)),
    ("multi_qudit_hamiltonian_jayne",
     ((3, 2), [1.0, 2.0], 1.5, np.array([[0.1, 0.01], [0.01, 0.2]]),
      np.array([[0.0, 0.05], [0.05, 0.0]]))),
])
def test_builders_equal_jax_package(name, args):
    ours = getattr(tm, name)(*args)
    ref = getattr(jm, name)(*args)
    if isinstance(ref, tuple):
        ours, ref = [x for t in ours for x in t], [x for t in ref for x in t]
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


@pytest.mark.parametrize("builder,kw", [
    ("cnot3_problem", dict(nsteps=1000)),
    ("cnot2_problem", dict(tf=11.0, nsteps=20)),
])
def test_problem_from_jax_arrays_equals_port_builder(builder, kw):
    jprob = dataclasses.replace(getattr(jm, builder)(**kw), solver="schulz",
                                schulz_iters=48, schulz_warm_budget=0)
    arrays = {f: np.asarray(getattr(jprob, f)) for f in _FIELDS + ("tf",)}
    carried = qt.problem_from_arrays(
        arrays, nsteps=jprob.nsteps, N_ess_levels=jprob.N_ess_levels,
        solver=jprob.solver, schulz_iters=jprob.schulz_iters,
        schulz_warm_budget=jprob.schulz_warm_budget, dtype=jprob.dtype,
        device="cpu")
    ours = getattr(tm, builder)(solver="schulz", schulz_iters=48,
                                schulz_warm_budget=0, device="cpu", **kw)
    for f in _FIELDS:
        a, b = getattr(carried, f), getattr(ours, f)
        assert a.dtype == b.dtype == torch.float64
        assert torch.equal(a, b), f
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jprob, f)))
    for f in ("tf", "nsteps", "N_ess_levels", "solver", "schulz_iters",
              "schulz_warm_budget", "dtype"):
        assert getattr(carried, f) == getattr(ours, f), f
    assert ours.real_system_size == jprob.real_system_size
    assert ours.N_operators == jprob.N_operators
    assert ours.N_initial_conditions == jprob.N_initial_conditions
    np.testing.assert_array_equal(ours.w0.numpy(), np.asarray(jprob.w0))


def test_working_problem_casts_propagation_arrays_only():
    prob = tm.cnot2_problem(tf=11.0, nsteps=20, dtype="float32",
                            device="cpu")
    w = qt.working_problem(prob)
    assert w.work_dtype == torch.float32
    for f in ("system_sym", "system_asym", "sym_operators",
              "asym_operators", "u0", "v0"):
        assert getattr(w, f).dtype == torch.float32
    assert w.guard_subspace_projector.dtype == torch.float64
    assert isinstance(w.tf, float)
    assert qt.working_problem(tm.cnot2_problem(device="cpu")) is not None


def test_problem_validation_raises_like_jax():
    H = np.array([[0.0, 1.0], [2.0, 0.0]])
    with pytest.raises(ValueError, match="not symmetric"):
        qt.schrodinger_problem(H, np.zeros((2, 2)), [], [], np.eye(2),
                               np.zeros((2, 2)), 1.0, 10, 2, device="cpu")
    with pytest.raises(ValueError):
        qgd_tpu.problem.schrodinger_problem(
            H, np.zeros((2, 2)), [], [], np.eye(2), np.zeros((2, 2)), 1.0,
            10, 2)


@pytest.mark.parametrize("build", [
    lambda **kw: tm.cnot2_problem(tf=11.0, nsteps=4, **kw),
    lambda **kw: qt.schrodinger_problem(np.eye(2), np.zeros((2, 2)), [], [],
                                        np.eye(2), np.zeros((2, 2)), 1.0, 4,
                                        2, **kw),
    lambda **kw: qt.problem_from_arrays(
        {f: np.asarray(getattr(jm.cnot2_problem(tf=11.0, nsteps=4), f))
         for f in _FIELDS + ("tf",)}, nsteps=4, N_ess_levels=4, **kw),
], ids=["cnot2_problem", "schrodinger_problem", "problem_from_arrays"])
def test_builders_default_to_the_card(build):
    """The default device is CUDA: without a GPU the default raises, and
    ``device="cpu"`` builds on the CPU."""
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert build(device="cpu").device == torch.device("cpu")


JC = ((3, 2), (2, 2), [1.0, 2.0], 1.5, np.array([[0.1, 0.01], [0.01, 0.2]]),
      np.array([[0.0, 0.05], [0.05, 0.0]]), 2.0, 16)


@pytest.mark.parametrize("builder,args,kw", [
    ("construct_rand_prob", (3, 2), dict(tf=2.0, nsteps=24, seed=7)),
    ("dahlquist_problem", (2.5j, 0.3 + 0.4j), dict(with_control=True)),
    ("rotating_frame_qubit", (3, 1), dict(nsteps=20, detuning_frequency=0.4,
                                          self_kerr_coefficient=0.2)),
    ("JaynesCummingsProblem", JC, {}),
    ("vector_problem", None, {}),
])
def test_problem_builders_equal_jax_package(builder, args, kw):
    """The remaining builders give the JAX package's arrays bit for bit
    (``vector_problem``: column 2 of the random problem)."""
    if builder == "vector_problem":
        jprob = jm.construct_rand_prob(3, 2, seed=7)
        jprob = qgd_tpu.vector_problem(jprob, 2)
        ours = qt.vector_problem(qt.construct_rand_prob(3, 2, seed=7,
                                                        device="cpu"), 2)
    else:
        jprob = getattr(jm, builder)(*args, **kw)
        ours = getattr(qt, builder)(*args, device="cpu", **kw)
    for f in _FIELDS + ("tf",):
        np.testing.assert_array_equal(
            np.asarray(torch.as_tensor(getattr(ours, f))),
            np.asarray(getattr(jprob, f)), err_msg=f)
    assert (ours.nsteps, ours.N_ess_levels) == (jprob.nsteps,
                                                jprob.N_ess_levels)


def test_top_level_exports_and_repr():
    """Every builder name the JAX package exports at its top level is a
    top-level name of the port; the summary names the GMRES settings."""
    names = set(jm.__all__) & set(qgd_tpu.__all__)
    assert names and not [n for n in names if not hasattr(qt, n)]
    prob = qt.rotating_frame_qubit(3, 1, device="cpu", solver="gmres",
                                   gmres_iters=12,
                                   preconditioner_type="diagonal")
    text = repr(prob)
    assert "gmres_iters = 12" in text and "'diagonal'" in text
    assert "real system size 8" in text
