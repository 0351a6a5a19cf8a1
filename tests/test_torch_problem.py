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
        schulz_warm_budget=jprob.schulz_warm_budget, dtype=jprob.dtype)
    ours = getattr(tm, builder)(solver="schulz", schulz_iters=48,
                                schulz_warm_budget=0, **kw)
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
    prob = tm.cnot2_problem(tf=11.0, nsteps=20, dtype="float32")
    w = qt.working_problem(prob)
    assert w.work_dtype == torch.float32
    for f in ("system_sym", "system_asym", "sym_operators",
              "asym_operators", "u0", "v0"):
        assert getattr(w, f).dtype == torch.float32
    assert w.guard_subspace_projector.dtype == torch.float64
    assert isinstance(w.tf, float)
    assert qt.working_problem(tm.cnot2_problem()) is not None


def test_problem_validation_raises_like_jax():
    H = np.array([[0.0, 1.0], [2.0, 0.0]])
    with pytest.raises(ValueError, match="not symmetric"):
        qt.schrodinger_problem(H, np.zeros((2, 2)), [], [], np.eye(2),
                               np.zeros((2, 2)), 1.0, 10, 2)
    with pytest.raises(ValueError):
        qgd_tpu.problem.schrodinger_problem(
            H, np.zeros((2, 2)), [], [], np.eye(2), np.zeros((2, 2)), 1.0,
            10, 2)
