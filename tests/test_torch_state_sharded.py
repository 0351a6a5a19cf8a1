"""Level-sharded GMRES propagation (``qgd_tpu_torch.parallel.
tp_forward_history``) on two gloo ranks on the CPU, against the port's
single-process GMRES history and the JAX package's (``eval_forward`` with
``solver="gmres"``, as ``tests/test_sharding.py`` holds its own
tensor-parallel path).

rotating_frame_qubit(6, 2): N = 8 levels, 4 per rank, 2N = 16, 16 Arnoldi
steps, 15 steps of order 4. The two worker processes import no JAX; they
meet at a free localhost port. Tolerance 1e-9 absolute, as the JAX test's:
the sharded products are the single-process ones cut into row blocks, so
only roundoff separates them.
"""

import dataclasses
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

import qgd_tpu  # noqa: E402
import qgd_tpu_torch as qt  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RFQ = dict(tf=1.0, nsteps=15, detuning_frequency=0.3,
           self_kerr_coefficient=0.1)
WORKER = """
import json, sys
import numpy as np, torch
import qgd_tpu_torch as qt
from qgd_tpu_torch.parallel import make_tp_mesh, tp_forward_history

torch.set_num_threads(1)
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
rfq = json.loads(sys.argv[4])
group = make_tp_mesh(2, device="cpu", init_method=f"tcp://localhost:{port}",
                     rank=rank)
ctrl = qt.BSpline2Control(4, 1.0)
pcof = np.random.default_rng(4).standard_normal((2, 8)) * 0.2
hist = {}
for pc in ("identity", "diagonal"):
    prob = qt.rotating_frame_qubit(6, 2, device="cpu", solver="gmres",
                                   gmres_iters=16, preconditioner_type=pc,
                                   **rfq)
    hist[pc] = tp_forward_history(prob, ctrl, pcof, group, 4).numpy()
try:
    make_tp_mesh(2, device="cuda")
    refused = False
except ValueError:
    refused = True
modules = sorted(m for m in sys.modules if m == "jax" or m == "qgd_tpu"
                 or m.startswith(("jax.", "qgd_tpu.")))
if rank == 0:
    np.savez(out, refused=refused, modules=json.dumps(modules), **hist)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_matches_single_process_and_jax(tmp_path):
    out = tmp_path / "hist.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    args = [str(_free_port()), str(out), json.dumps(RFQ)]
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
    got = np.load(out)
    assert bool(got["refused"]) and json.loads(str(got["modules"])) == []

    pcof = np.random.default_rng(4).standard_normal((2, 8)) * 0.2
    ctrl = qt.BSpline2Control(4, 1.0)
    for pc in ("identity", "diagonal"):
        prob = qt.rotating_frame_qubit(6, 2, device="cpu", solver="gmres",
                                       gmres_iters=16, preconditioner_type=pc,
                                       **RFQ)
        ref = qt.eval_forward(prob, ctrl, pcof, 4).numpy()
        assert got[pc].shape == ref.shape == (2, 16, 16, 6)
        assert np.abs(got[pc] - ref).max() <= 1e-9
    jprob = dataclasses.replace(
        qgd_tpu.models.rotating_frame_qubit(6, 2, **RFQ), solver="gmres",
        gmres_iters=16)
    for s in range(2):
        jref = np.asarray(qgd_tpu.eval_forward(
            jprob, qgd_tpu.BSpline2Control(4, 1.0), jnp.asarray(pcof[s]), 4))
        assert np.abs(got["identity"][s] - jref).max() <= 1e-9
