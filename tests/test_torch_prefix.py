"""The ported prefix-product route (qgd_tpu_torch.prefix) against
qgd_tpu.prefix on the CPU: the forward history, the objective and the
gradient at 1 and 4 segments, f64 and f32, the memory guard, and the
route wired into both optimizers.

Tolerances: f64 relative <= 1e-11 (the same maps multiplied in the same
order of combination; the exact f64 inverses differ in roundoff);
f32 port against f32 JAX, both folding 2 refinement sweeps into their
effective inverses, objective <= 1e-5 and gradient <= 1e-4 relative (the
f32 roundoff of 24 matrix products). Optimizer objectives relative <= 1e-9
over 3 iterations, as in test_torch_optimize.py.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import qgd_tpu  # noqa: E402
from qgd_tpu import prefix as jp  # noqa: E402
import qgd_tpu_torch as qt  # noqa: E402

torch.set_num_threads(1)

NSTEPS, TF, S = 24, 13.2, 2          # dt = 0.55, the main path's step
SWAP = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=np.complex128)


def _setup(dtype):
    kw = dict(solver="schulz", schulz_iters=48, schulz_warm_budget=0)
    jprob = dataclasses.replace(
        qgd_tpu.models.cnot3_problem(tf=TF, nsteps=NSTEPS), dtype=dtype, **kw)
    tprob = qt.cnot3_problem(tf=TF, nsteps=NSTEPS, dtype=dtype, device="cpu",
                             **kw)
    jc = tuple(qgd_tpu.BSpline2Control(10, TF) for _ in range(3))
    tc = tuple(qt.BSpline2Control(10, TF) for _ in range(3))
    pcof = np.random.default_rng(0).standard_normal((S, 60)) * 0.01
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))
    return jprob, jc, tprob, tc, pcof, tgt


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n_segments", [1, 4])
def test_prefix_route_matches_jax_f64(n_segments):
    jprob, jc, tprob, tc, pcof, tgt = _setup("float64")
    kw = dict(ridge_penalty_strength=1e-3, n_segments=n_segments)
    (j1, guard, ridge), grad = qt.prefix_objective_and_gradient(
        tprob, tc, pcof, tgt, 4, **kw)
    val = qt.prefix_objective_value(tprob, tc, pcof, tgt, 4, **kw)
    hist = qt.eval_forward_prefix(tprob, tc, pcof, 4, n_segments=n_segments)
    assert grad.shape == (S, 60) and hist.shape == (S, NSTEPS + 1, 128, 8)
    for s in range(S):
        pc = jnp.asarray(pcof[s])
        (jj1, jg, jr), jgrad = jp.prefix_objective_and_gradient(
            jprob, jc, pc, tgt, 4, **kw)
        assert _rel(j1[s], jj1) <= 1e-11 and _rel(guard[s], jg) <= 1e-11
        assert _rel(ridge[s], jr) <= 1e-14
        assert _rel(grad[s], jgrad) <= 1e-11
        # JAX's value-only entry is j1 + guard + ridge of the same pass
        assert _rel(val[s], jj1 + jg + jr) <= 1e-11
        assert _rel(hist[s], jp.eval_forward_prefix(
            jprob, jc, pc, 4, n_segments=n_segments)) <= 1e-11
    # the same objective as the serial routes: exact inverses in f64
    lu = dataclasses.replace(tprob, solver="lu")
    (sj1, sg, _), sgrad = qt.segmented_objective_and_gradient(
        lu, tc, pcof, tgt, 4, ridge_penalty_strength=1e-3, n_segments=4)
    assert _rel(j1, sj1) <= 1e-11 and _rel(grad, sgrad) <= 1e-11


def test_prefix_route_f32_matches_jax_f32():
    jprob, jc, tprob, tc, pcof, tgt = _setup("float32")
    (j1, guard, _), grad = qt.prefix_objective_and_gradient(
        tprob, tc, pcof[:1], tgt, 4, n_segments=4, refine_sweeps=2)
    (jj1, jg, _), jgrad = jp.prefix_objective_and_gradient(
        jprob, jc, jnp.asarray(pcof[0]), tgt, 4, n_segments=4)
    assert _rel(j1[0] + guard[0], jj1 + jg) <= 1e-5
    assert _rel(grad[0], jgrad) <= 1e-4


def test_prefix_memory_guard_refuses_long_segments():
    """Segments whose (S·L, n, n) tensors pass the 1.5 GB hoisting cap are
    refused with the numbers, never quietly re-routed; a segment count
    that does not divide nsteps is refused too."""
    _, _, tprob, tc, pcof, tgt = _setup("float32")
    many = np.repeat(pcof, 128, axis=0)                 # 256 scenarios
    with pytest.raises(ValueError, match="GB cap"):
        qt.prefix_objective_value(tprob, tc, many, tgt, 4, n_segments=1)
    with pytest.raises(ValueError, match="must divide"):
        qt.prefix_objective_value(tprob, tc, pcof, tgt, 4, n_segments=5)


def test_prefix_route_of_both_optimizers_matches_jax():
    """optimize_gate(gradient_route="prefix") (L-BFGS-B) and the batched
    multistart on the prefix route, 3 iterations each, against JAX."""
    jprob = qgd_tpu.construct_rabi_prob(nsteps=40)
    tprob = qt.construct_rabi_prob(nsteps=40, device="cpu")
    jc, tc = qgd_tpu.GRAPEControl(1, float(jprob.tf)), qt.GRAPEControl(
        1, tprob.tf)
    kw = dict(order=4, maxIter=3, ridge_penalty_strength=1e-2, print_level=0,
              gradient_route="prefix", n_segments=4)
    ref = qgd_tpu.optimize_gate(jprob, jc, jnp.array([0.4, 0.1]), SWAP, **kw)
    hist = qt.optimize_gate(tprob, tc, np.array([0.4, 0.1]), SWAP, **kw)
    n = len(ref.obj_value)
    assert len(hist.obj_value) == n >= 3
    np.testing.assert_allclose(hist.obj_value, ref.obj_value, rtol=1e-9,
                               atol=1e-14)
    starts = np.array([[0.4, 0.1], [0.55, -0.05]])
    jpc, jobjs = qgd_tpu.optimize_gate_multistart(
        jprob, jc, jnp.asarray(starts), SWAP, **kw)
    tpc, tobjs = qt.optimize_gate_multistart(tprob, tc, starts, SWAP, **kw)
    np.testing.assert_allclose(tobjs, jobjs, rtol=1e-9)
    np.testing.assert_allclose(tpc.numpy(), np.asarray(jpc), rtol=0,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# The f32 drift at a long horizon: a script, not a test (minutes on the
# CPU at 5500 steps).
#
#     QGD_REFINE_SWEEPS_F32=3 PYTHONPATH=. python tests/test_torch_prefix.py
#
# The JAX package reads its f32 refinement sweeps (default 2) from the
# environment at import; the port's prefix route is run with the same
# number, so both sides fold the same refinement into their inverses.
# ---------------------------------------------------------------------------

def f32_drift_witness(nsteps: int, threads: int = 4) -> dict:
    """CNOT3 at ``nsteps`` (dt = 0.1) with the 180 carrier parameters at
    the start point of ``chip_smoke.py``'s optimize phase (uniform in
    +-0.002, seed 0; ridge 1e-2): how far the f32 prefix route and the f32
    plain route lie from the f64 LU route, in JAX and in the port on the
    CPU, how far the port's f32 routes lie from JAX's, and how far each
    side's f32 prefix route lies from its f32 plain route. Each entry is
    ``(|d objective|, |d grad| / |grad|)``."""
    from qgd_tpu.ops.linalg import REFINE_SWEEPS_F32

    torch.set_num_threads(threads)
    tf = 0.1 * nsteps
    kw32 = dict(solver="schulz", schulz_warm_budget=0)
    freqs = qgd_tpu.models.cnot3_carrier_frequencies()
    jc = [qgd_tpu.CarrierControl(qgd_tpu.BSpline2Control(10, tf), f)
          for f in freqs]
    tc = [qt.CarrierControl(qt.BSpline2Control(10, tf), f) for f in freqs]
    pcof = np.random.default_rng(0).uniform(-0.002, 0.002, 180)
    tgt = qgd_tpu.models.cnot3_target(tf=tf)
    kw = dict(ridge_penalty_strength=1e-2)

    def jax_route(prob, fn):
        (j1, g, r), grad = fn(prob, jc, jnp.asarray(pcof), tgt, 4, **kw)
        return float(j1 + g + r), np.asarray(grad, dtype=np.float64)

    def port_route(prob, fn, **extra):
        (j1, g, r), grad = fn(prob, tc, pcof, tgt, 4, **kw, **extra)
        return float(j1 + g + r), grad.double().numpy()

    jprob64 = qgd_tpu.models.cnot3_problem(tf=tf, nsteps=nsteps)
    jprob32 = dataclasses.replace(jprob64, dtype="float32", **kw32)
    tprob32 = qt.cnot3_problem(tf=tf, nsteps=nsteps, dtype="float32",
                               device="cpu", **kw32)
    plain = qgd_tpu.adjoint.objective_and_gradient
    res = {
        "f64 lu, jax": jax_route(jprob64, plain),
        "f64 lu, port": port_route(
            qt.cnot3_problem(tf=tf, nsteps=nsteps, device="cpu"),
            qt.objective_and_gradient),
        "f32 plain, jax": jax_route(jprob32, plain),
        "f32 prefix, jax": jax_route(jprob32,
                                     jp.prefix_objective_and_gradient),
        "f32 plain, port": port_route(tprob32, qt.objective_and_gradient),
        "f32 prefix, port": port_route(
            tprob32, qt.prefix_objective_and_gradient,
            refine_sweeps=REFINE_SWEEPS_F32),
    }
    ref_obj, ref_grad = res["f64 lu, jax"]

    def delta(a, b):
        return abs(a[0] - b[0]), _rel(a[1], b[1])

    out = {"nsteps": nsteps, "refine_sweeps_f32": REFINE_SWEEPS_F32,
           "objective_f64": ref_obj}
    for name, val in res.items():
        if name != "f64 lu, jax":
            out[f"{name} vs f64 lu, jax"] = delta(val, res["f64 lu, jax"])
    for route in ("plain", "prefix"):
        out[f"f32 {route}, port vs jax"] = delta(res[f"f32 {route}, port"],
                                                 res[f"f32 {route}, jax"])
    for side in ("jax", "port"):
        out[f"f32 prefix vs f32 plain, {side}"] = delta(
            res[f"f32 prefix, {side}"], res[f"f32 plain, {side}"])
    return out


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description=f32_drift_witness.__doc__)
    ap.add_argument("--nsteps", type=int, default=5500)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    print(json.dumps(f32_drift_witness(args.nsteps, args.threads)))
