"""The port's host-chunked long-horizon route (``qgd_tpu_torch.chunked``)
against ``qgd_tpu.chunked`` on the CPU, in float64.

* Guarded CNOT3 at 48 steps (``tests/test_chunked.py``'s case), 12
  segments in 4 chunks of 3, orders 2 and 4: objective parts and gradient
  against JAX's chunked route and the port's segmented route within 1e-12
  relative (the same per-segment arithmetic; only the gradient's sum over
  time points is cut at other places), and the same progress calls.
* The chunk rules: the chunk divisor, the ``segments_per_chunk`` and
  ``n_segments`` errors and the warning when one segment exceeds the cap,
  as JAX gives them; which problems capture their segment programs.
* ``optimize_gate(max_dispatch_steps=...)`` against the plain route
  (objectives rtol 1e-9, as JAX's test holds its own); the setup carries
  ``max_dispatch_steps`` and ``n_segments`` both ways with the JAX
  package's files, and a resumed run stays on the chunked route;
  ``method="lbfgs"`` with ``max_dispatch_steps`` raises as in JAX.
* ``mesh=``: the gate columns split 2 + 2 over two gloo processes on a
  1 x 2 mesh against one process, within 1e-12.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
from qgd_tpu.chunked import _chunk_divisor as j_divisor  # noqa: E402
from qgd_tpu.chunked import chunked_objective_and_gradient as j_chunked  # noqa
import qgd_tpu_torch as qt  # noqa: E402
from qgd_tpu_torch import chunked, segmented  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-12
RFQ = dict(tf=1.0, nsteps=20, detuning_frequency=0.3,
           self_kerr_coefficient=0.1)


def _case(nsteps):
    """tests/test_chunked.py's guarded CNOT3 case, for both packages."""
    jprob = qgd_tpu.models.cnot3_problem(nsteps=nsteps)
    tprob = qt.cnot3_problem(nsteps=nsteps, device="cpu")
    jc = tuple(qgd_tpu.BSpline2Control(4, float(jprob.tf)) for _ in range(3))
    tc = tuple(qt.BSpline2Control(4, tprob.tf) for _ in range(3))
    rng = np.random.default_rng(11)
    pcof = rng.standard_normal(24) * 0.05
    tgt = rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))
    return jprob, jc, tprob, tc, pcof, tgt


def _rel(x, ref):
    x, ref = np.asarray(x, dtype=np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("order", [2, 4])
def test_chunked_matches_jax(order):
    jprob, jc, tprob, tc, pcof, tgt = _case(48)
    kw = dict(ridge_penalty_strength=1e-2, n_segments=12,
              segments_per_chunk=3)
    j_calls, t_calls = [], []
    (jj1, jg, jr), jgrad = j_chunked(
        jprob, jc, jnp.asarray(pcof), tgt, order,
        progress=lambda ph, k, n, w: j_calls.append((ph, k, n)), **kw)
    (j1, g, r), grad = qt.chunked_objective_and_gradient(
        tprob, tc, pcof, tgt, order,
        progress=lambda ph, k, n, w: t_calls.append((ph, k, n)), **kw)
    for x in (j1, g, r, grad):
        assert x.dtype == torch.float64 and x.device.type == "cpu"
    for x, ref in ((j1, jj1), (g, jg), (r, jr), (grad, jgrad)):
        assert _rel(x, ref) <= TOL
    assert t_calls == j_calls and len(t_calls) == 9   # 4 + terminal + 4
    (sj1, sg, sr), sgrad = qt.segmented_objective_and_gradient(
        tprob, tc, pcof, tgt, order, ridge_penalty_strength=1e-2,
        n_segments=12)
    for x, ref in ((j1, sj1), (g, sg), (r, sr), (grad, sgrad)):
        assert _rel(x, ref) <= TOL


def test_chunk_rules_match_jax():
    for S in range(1, 31):
        for L in (1, 3, 8, 10):
            for cap in (0, 5, 7, 8, 17, 40, 100):
                assert chunked._chunk_divisor(S, L, cap) == j_divisor(S, L,
                                                                      cap)
    jprob = qgd_tpu.models.construct_rabi_prob(nsteps=8)
    tprob = qt.construct_rabi_prob(nsteps=8, device="cpu")
    jc, tc = qgd_tpu.GRAPEControl(1, float(jprob.tf)), qt.GRAPEControl(
        1, tprob.tf)
    p0, swap = np.array([0.4, 0.1]), np.array([[0, 1], [1, 0]], complex)
    runs = ((j_chunked, jprob, jc, jnp.asarray(p0)),
            (qt.chunked_objective_and_gradient, tprob, tc, p0))
    for fn, prob, c, pc in runs:
        with pytest.raises(ValueError, match="segments_per_chunk=3 must "
                                             "divide S=4"):
            fn(prob, c, pc, swap, 2, n_segments=4, segments_per_chunk=3)
        with pytest.raises(ValueError, match="n_segments=3 must divide"):
            fn(prob, c, pc, swap, 2, n_segments=3)
    # one segment of 4 steps past a cap of 3: both warn and run on
    out = []
    for fn, prob, c, pc in runs:
        with pytest.warns(UserWarning, match="L=4 alone exceeds "
                                             "max_dispatch_steps=3"):
            out.append(fn(prob, c, pc, swap, 2, n_segments=2,
                          max_dispatch_steps=3))
    (jparts, jgrad), (tparts, tgrad) = out
    assert _rel(tgrad, jgrad) <= TOL
    assert all(_rel(t, j) <= TOL for t, j in zip(tparts, jparts))
    # which problems capture their segment programs (the segmented
    # module's docstring, whose programs the chunked route runs): a CUDA
    # problem unless its solver is GMRES; a CPU problem never
    card = lambda solver: types.SimpleNamespace(
        device=torch.device("cuda"), solver=solver)
    assert [segmented._captures(card(s))
            for s in ("lu", "schulz", "gmres")] \
        == [True, True, False]
    assert not segmented._captures(tprob)


def test_optimize_gate_chunked_route(tmp_path, monkeypatch):
    from qgd_tpu import checkpoint as jcp
    from qgd_tpu_torch import checkpoint as tcp

    _, _, tprob, tc, pcof, tgt = _case(48)
    kw = dict(order=2, maxIter=3, ridge_penalty_strength=1e-2,
              print_level=0, max_cpu_time=600.0)
    routed = []
    route = chunked.chunked_objective_and_gradient

    def spy(*args, **kwargs):
        routed.append(kwargs["max_dispatch_steps"])
        return route(*args, **kwargs)

    monkeypatch.setattr(chunked, "chunked_objective_and_gradient", spy)
    h_plain = qt.optimize_gate(tprob, tc, pcof, tgt, **kw)
    assert routed == []
    base = str(tmp_path / "port")
    # L = 4, a cap of 24 steps: 6 segments per chunk, 2 chunks
    h_chunk = qt.optimize_gate(tprob, tc, pcof, tgt, n_segments=12,
                               max_dispatch_steps=24, filename=base, **kw)
    n = min(len(h_plain.obj_value), len(h_chunk.obj_value))
    assert n >= 2 and routed == [24] * len(h_chunk.obj_value)
    np.testing.assert_allclose(h_chunk.obj_value[:n], h_plain.obj_value[:n],
                               rtol=1e-9)
    # the port's setup, read by both packages
    for setup in (tcp.load_setup(base, device="cpu"), jcp.load_setup(base)):
        assert (setup["max_dispatch_steps"], setup["n_segments"]) == (24, 12)
    del routed[:]
    h_res = tcp.resume_optimization(base, device="cpu", maxIter=1)
    assert len(h_res.obj_value) > len(h_chunk.obj_value)
    assert routed and set(routed) == {24}

    # a setup and history the JAX package wrote resume on the chunked route
    jprob, jc, _, _, _, _ = _case(48)
    jbase = str(tmp_path / "jax")
    jcp.save_setup(jbase, jprob, jc, tgt, order=2,
                   ridge_penalty_strength=1e-2, maxIter=1, print_level=0,
                   n_segments=12, max_dispatch_steps=24)
    jh = qgd_tpu.optimize.OptimizationHistory()
    jh.append(0, h_chunk.obj_value[0], 0.0, pcof, h_chunk.grad_pcof[0],
              h_chunk.infidelity[0], h_chunk.guard_penalty[0],
              h_chunk.ridge_penalty[0])
    jh.save(jbase)
    del routed[:]
    h_j = tcp.resume_optimization(jbase, device="cpu")
    assert routed and set(routed) == {24}
    assert h_j.iter_count[:2] == [0, 1]
    np.testing.assert_allclose(h_j.obj_value[1], h_chunk.obj_value[0],
                               rtol=1e-12)

    # method="lbfgs" cannot drive the chunked route, in either package
    for pkg, prob, c in ((qgd_tpu, jprob, jc), (qt, tprob, tc)):
        with pytest.raises(ValueError, match="lbfgsb"):
            pkg.optimize_gate(prob, c, pcof, tgt, order=2, maxIter=2,
                              method="lbfgs", n_segments=12,
                              max_dispatch_steps=24, print_level=0)


WORKER = """
import json, sys
import numpy as np, torch
import qgd_tpu_torch as qt
from qgd_tpu_torch.parallel import initialize_distributed, make_mesh

torch.set_num_threads(1)
rank, port, out, rfq = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    json.loads(sys.argv[4])
initialize_distributed(f"localhost:{port}", 2, rank, device="cpu")
prob = qt.rotating_frame_qubit(4, 2, device="cpu", **rfq)
rng = np.random.default_rng(11)
pcof = rng.standard_normal(10) * 0.2
tgt = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
calls = []
(j1, g, r), grad = qt.chunked_objective_and_gradient(
    prob, qt.BSpline2Control(5, 1.0), pcof, tgt, 4,
    ridge_penalty_strength=1e-2, n_segments=4, segments_per_chunk=2,
    progress=lambda ph, k, n, w: calls.append(ph), mesh=make_mesh(1, 2))
np.savez(out + f".{rank}.npz", parts=np.array([j1, g, r]), grad=grad.numpy(),
         calls=json.dumps(calls), jax=any(m == "jax" or m.startswith("jax.")
                                          for m in sys.modules))
torch.distributed.destroy_process_group()
"""


def test_chunked_column_split_over_two_processes(tmp_path):
    from test_torch_sharded import _free_port

    out = tmp_path / "res"
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

    prob = qt.rotating_frame_qubit(4, 2, device="cpu", **RFQ)
    rng = np.random.default_rng(11)
    pcof = rng.standard_normal(10) * 0.2
    tgt = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    (j1, g, r), grad = qt.chunked_objective_and_gradient(
        prob, qt.BSpline2Control(5, 1.0), pcof, tgt, 4,
        ridge_penalty_strength=1e-2, n_segments=4, segments_per_chunk=2)
    for rank in (0, 1):
        got = np.load(f"{out}.{rank}.npz")
        assert not bool(got["jax"])
        assert json.loads(str(got["calls"])) == ["fwd", "fwd", "terminal",
                                                 "bwd", "bwd"]
        for x, ref in zip(got["parts"], (j1, g, r)):
            assert _rel(x, ref) <= TOL
        assert _rel(got["grad"], grad) <= TOL
