"""Gate-column and scenario sharding of the port (``qgd_tpu_torch.
parallel.sharded``) and the ``ic_group`` reduction of every gradient
route, on the CPU with gloo, in float64.

* A one-rank group: each route with ``ic_group`` gives what it gives with
  ``None``, bit for bit (a one-rank sum is the identity).
* Two gloo processes, as ``tests/test_multihost.py`` runs the JAX
  package's, on a 2 x 1 and a 1 x 2 ``(scenario, ic)`` mesh: the sharded
  and batched objectives and gradients of every gradient method against
  the JAX package's single-device ``objective_and_gradient``, within
  1e-12 (the sharded sums are the single-device sums cut into column
  blocks, so only roundoff separates them), and three training steps
  that lower the objective.

``tests/test_sharding.py``'s problem: rotating_frame_qubit(4, 2), 6
levels, 4 gate columns, 20 steps of order 4, BSpline2Control(5).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import qgd_tpu  # noqa: E402
from qgd_tpu.adjoint import objective_and_gradient as jax_oag  # noqa: E402
import qgd_tpu_torch as qt  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RFQ = dict(tf=1.0, nsteps=20, detuning_frequency=0.3,
           self_kerr_coefficient=0.1)
RIDGE = 1e-2
TOL = 1e-12
METHODS = ("lagrange", "segmented", "ad")


def _inputs():
    rng = np.random.default_rng(11)
    pcof = rng.standard_normal(10) * 0.2
    tgt = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    pcofs = rng.standard_normal((4, 10)) * 0.2
    return pcof, tgt, pcofs


@pytest.fixture(scope="module")
def one_rank_group():
    """A one-rank gloo default group for this process, taken down after
    the module."""
    if dist.is_initialized():
        pytest.skip("torch.distributed is already initialized here")
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _routes():
    """``name -> fn(prob, controls, pcofs, tgt, ic_group)`` returning a
    tuple of tensors."""
    def oag(route, **kw):
        def run(p, c, pc, tgt, g):
            (j1, guard, ridge), grad = route(p, c, pc, tgt, 4,
                                             ridge_penalty_strength=RIDGE,
                                             ic_group=g, **kw)
            return j1, guard, ridge, grad
        return run
    return {
        "lagrange": oag(qt.objective_and_gradient),
        "segmented_L1": oag(qt.segmented_objective_and_gradient,
                            n_segments=20),
        "segmented_L5_tracking": oag(qt.segmented_objective_and_gradient,
                                     n_segments=4, cost_type="Tracking"),
        "segmented_value": lambda p, c, pc, tgt, g: (
            qt.segmented_objective_value(p, c, pc, tgt, 4,
                                         cost_type="Norm", ic_group=g),),
        "prefix": oag(qt.prefix_objective_and_gradient, n_segments=4),
    }


@pytest.mark.parametrize("route", sorted(_routes()))
def test_one_rank_group_is_the_identity(route, one_rank_group):
    prob = qt.rotating_frame_qubit(4, 2, device="cpu", **RFQ)
    ctrl = qt.BSpline2Control(5, 1.0)
    _, tgt, pcofs = _inputs()
    fn = _routes()[route]
    with_group = fn(prob, ctrl, pcofs, tgt, one_rank_group)
    without = fn(prob, ctrl, pcofs, tgt, None)
    for a, b in zip(with_group, without):
        assert a.dtype == b.dtype == torch.float64
        assert torch.equal(a, b)


WORKER = """
import json, sys
import numpy as np, torch
import qgd_tpu_torch as qt
from qgd_tpu_torch.parallel import (initialize_distributed, make_mesh,
    sharded_objective_and_grad, batched_objective_and_grad,
    multichip_train_step)

torch.set_num_threads(1)
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
n_sc, n_ic = map(int, sys.argv[4].split("x"))
rfq, methods, ridge = json.loads(sys.argv[5])
initialize_distributed(f"localhost:{port}", 2, rank, device="cpu")
initialize_distributed(f"localhost:{port}", 2, rank, device="cpu")  # no-op
mesh = make_mesh(n_sc, n_ic)
try:
    make_mesh(2, 2)
    wrong_size_refused = False
except ValueError:
    wrong_size_refused = True
prob = qt.rotating_frame_qubit(4, 2, device="cpu", **rfq)
ctrl = qt.BSpline2Control(5, 1.0)
rng = np.random.default_rng(11)
pcof = rng.standard_normal(10) * 0.2
tgt = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
pcofs = rng.standard_normal((4, 10)) * 0.2
res = {}
for m in methods + ["auto"]:
    v, g = sharded_objective_and_grad(prob, ctrl, pcof, tgt, mesh, 4,
                                      ridge_penalty_strength=ridge,
                                      gradient_method=m)
    vs, gs = batched_objective_and_grad(prob, ctrl, pcofs, tgt, mesh, 4,
                                        ridge, gradient_method=m)
    res.update({f"{m}_val": v.numpy(), f"{m}_grad": g.numpy(),
                f"{m}_vals": vs.numpy(), f"{m}_grads": gs.numpy()})
step = multichip_train_step(prob, ctrl, tgt, mesh, learning_rate=0.05)
p, means = torch.as_tensor(pcofs), []
for _ in range(3):
    p, vals = step(p)
    means.append(float(vals.mean()))
res["train_means"] = np.array(means)
np.savez(out + f".{rank}.npz", wrong_size_refused=wrong_size_refused,
         modules=json.dumps(sorted(m for m in sys.modules if m == "jax"
                                   or m.startswith("jax."))), **res)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's single-device objective (ridge included) and gradient at the
    single control vector and at each of the batch's, one compile."""
    jprob = qgd_tpu.models.rotating_frame_qubit(4, 2, **RFQ)
    jctrl = qgd_tpu.BSpline2Control(5, 1.0)
    pcof, tgt, pcofs = _inputs()
    out = []
    for pc in [pcof, *pcofs]:
        (j1, guard, ridge), grad = jax_oag(jprob, jctrl, jnp.asarray(pc),
                                           jnp.asarray(tgt), 4,
                                           ridge_penalty_strength=RIDGE)
        out.append((float(j1 + guard + ridge), np.asarray(grad)))
    return out


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_two_process_gloo_matches_jax(mesh, jax_reference, tmp_path):
    out = tmp_path / "res"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    args = [str(_free_port()), str(out), mesh,
            json.dumps([RFQ, list(METHODS), RIDGE])]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), *args],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs

    (val_ref, grad_ref), batch_ref = jax_reference[0], jax_reference[1:]
    vals_ref = np.array([v for v, _ in batch_ref])
    grads_ref = np.stack([g for _, g in batch_ref])
    for rank in (0, 1):
        got = np.load(f"{out}.{rank}.npz")
        assert bool(got["wrong_size_refused"])
        assert json.loads(str(got["modules"])) == []
        for m in METHODS + ("auto",):
            assert abs(float(got[f"{m}_val"]) - val_ref) <= TOL
            assert np.abs(got[f"{m}_grad"] - grad_ref).max() <= TOL
            assert got[f"{m}_vals"].shape == (4,)
            assert np.abs(got[f"{m}_vals"] - vals_ref).max() <= TOL
            assert np.abs(got[f"{m}_grads"] - grads_ref).max() <= TOL
        means = got["train_means"]
        assert means[2] < means[1] < means[0]
