"""GPU smoke run of qgd_tpu_torch: builds the CUDA stage kernels from the
sources in this checkout, checks each against its plain PyTorch version on
the card, then drives the main path once and checks what comes out.

The main path: the CNOT3 objective + exact discrete-adjoint gradient
(3 coupled transmons (4,4,4), real-stacked state 2N = 128, 8 gate-basis
columns, order 4, three BSpline2Control(10) pulses = 60 parameters,
nsteps = 1000, tf = 550), solver="schulz" with warm budget 0 and 3 f32
refinement sweeps, segment length 1, f32 propagation with f64 reductions,
for 256 control-vector scenarios.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit; exits non-zero, printing no result, without them. Imports no
JAX. The last line is a JSON object with "ok" and the device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

NSTEPS = 1000
SCENARIOS = 256
ORDER = 4
# f32 kernel vs f32 plain version of one kernel call: same arithmetic in
# another summation order.
KERNEL_REL_TOL = 1e-5
# f32 kernel route vs f32 plain route over 1000 steps (roundoff of two
# summation orders accumulates) and vs the f64 plain route.
ROUTE_OBJ_TOL, ROUTE_GRAD_TOL = 1e-5, 1e-4
F64_OBJ_TOL, F64_GRAD_TOL = 1e-4, 1e-3
# A broken stage solve sits at 1e-2 or worse.
RESIDUAL_LIMIT = 1e-6
# The 1e-7 stage-residual guard of the TPU runs, reported beside ours.
TPU_ERA_GUARD = 1e-7


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an NVIDIA "
                           "GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    phase("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
                    f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def build_phase():
    from qgd_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    info = cuda_build.build()
    cuda_build.load_library()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    phase("build", f"{time.perf_counter() - t0:.2f} s (nvcc "
                   f"{info['seconds']:.2f} s, cached={info['cached']}); "
                   + " | ".join(regs))


def _rel(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def _events_ms(fn, reps):
    """CUDA-event timings (ms) of ``reps`` runs of ``fn()``."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def _eager_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of one eager ``fn()`` call (ms). The host's
    launch gaps are included: this is what one call costs the step loop."""
    for _ in range(warmup):
        fn()
    return float(np.median(_events_ms(fn, reps)))


def _device_ms(fn, calls=20, reps=10):
    """Device time of one ``fn()`` call (ms): a CUDA graph holds ``calls``
    back-to-back calls, and the median of ``reps`` CUDA-event-timed replays
    is divided by ``calls``. The replay has no host launch gaps, so this is
    the card's own time. The operands (32 MB at the main-path shape) stay
    in the 50 MB L2 between calls, as they do in the step loop, where the
    stack is assembled just before the kernels read it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return float(np.median(_events_ms(graph.replay, reps))) / calls


def _main_path_stacks(prob, controls, pcof, dev):
    """Generator stacks (S, m, 2N, 2N) and states (S, 2N, 8) as the main
    path hands them to the kernels (f32, step 500's left end)."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.forward import _time_grid

    m = ORDER // 2
    wprob = qt.working_problem(prob)
    _, ts = _time_grid(prob)
    P, Q = qt.control_tables(controls, pcof, ts[500:501], m)
    A = qt.assemble_generator_stack(wprob, P[:, 0].float(), Q[:, 0].float(),
                                    m).contiguous()
    rng = np.random.default_rng(2)
    W = torch.tensor(rng.standard_normal((pcof.shape[0], 128, 8)),
                     dtype=torch.float32, device=dev)
    W = W / W.norm(dim=-2, keepdim=True)
    dt = torch.tensor(prob.tf / prob.nsteps, dtype=torch.float32,
                      device=dev)
    return A, W, dt


def kernel_phase(prob, controls, pcof, dev):
    from qgd_tpu_torch.ops import stage_kernels as sk

    # small shapes, every m the kernels are tested at, ragged tiles included
    for m in (1, 2, 3, 6):
        for B, n, b in ((3, 16, 4), (2, 130, 11)):
            rng = np.random.default_rng(m * 100 + n)
            A = torch.tensor(rng.standard_normal((B, m, n, n)) * 0.3,
                             dtype=torch.float32, device=dev)
            W = torch.tensor(rng.standard_normal((B, n, b)),
                             dtype=torch.float32, device=dev)
            e_l = _rel(sk.hermite_lhs_matrix_kernel_call(A, 0.05, m),
                       sk.lhs_matrix_plain(A, 0.05, m))
            e_r = _rel(sk.hermite_rhs_kernel_call(A, W, 0.05, m),
                       sk.rhs_plain(A, W, 0.05, m))
            check(e_l <= KERNEL_REL_TOL and e_r <= KERNEL_REL_TOL,
                  f"kernel vs plain at m={m} B={B} n={n} b={b}: "
                  f"lhs {e_l:.2e} rhs {e_r:.2e}")
    phase("kernels", "m in (1, 2, 3, 6) at (B,n,b) = (3,16,4), (2,130,11): "
                     f"kernel vs plain <= {KERNEL_REL_TOL:g} relative")

    # backward of each autograd.Function on the card vs the plain VJP
    rng = np.random.default_rng(9)
    A = torch.tensor(rng.standard_normal((3, 2, 16, 16)) * 0.1,
                     dtype=torch.float32, device=dev)
    W = torch.tensor(rng.standard_normal((3, 16, 4)), dtype=torch.float32,
                     device=dev)
    for name, kern, plain in (
            ("lhs", lambda a, w: sk.hermite_lhs_matrix_kernel_call(a, 0.37, 2),
             lambda a, w: sk.lhs_matrix_plain(a, 0.37, 2)),
            ("rhs", lambda a, w: sk.hermite_rhs_kernel_call(a, w, 0.37, 2),
             lambda a, w: sk.rhs_plain(a, w, 0.37, 2))):
        g = []
        for fn in (kern, plain):
            a = A.clone().requires_grad_(True)
            w = W.clone().requires_grad_(True)
            g.append(torch.autograd.grad((fn(a, w) ** 2).sum(), (a, w),
                                         allow_unused=True))
        for gk, gp in zip(*g):
            check((gk is None) == (gp is None), f"{name} backward inputs")
            if gp is not None:
                e = _rel(gk, gp)
                check(e <= 1e-4, f"{name} backward vs plain VJP: {e:.2e}")
    phase("kernels", "autograd backward on CUDA vs plain VJP <= 1e-4")

    # the main path's shapes: B=256 scenarios, 2N=128, m=2, b=8
    A, W, dt = _main_path_stacks(prob, controls, pcof, dev)
    m = ORDER // 2
    rows = []
    for name, src, replaces, kern, plain in (
            ("hermite_lhs_matrix", "qgd_tpu_torch/csrc/hermite_stage.cu",
             "qgd_tpu/ops/pallas_step.py:184",
             lambda: sk.hermite_lhs_matrix_kernel_call(A, dt, m),
             lambda: sk.lhs_matrix_plain(A, dt, m)),
            ("hermite_rhs", "qgd_tpu_torch/csrc/hermite_stage.cu",
             "qgd_tpu/ops/pallas_step.py:91",
             lambda: sk.hermite_rhs_kernel_call(A, W, dt, m),
             lambda: sk.rhs_plain(A, W, dt, m))):
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(rel <= KERNEL_REL_TOL,
              f"{name} at the main-path shape: {rel:.2e} relative")
        # plain, kernel, kernel, plain
        dev_ms = [_device_ms(f) for f in (plain, kern, kern, plain)]
        ms = float(np.mean(dev_ms[1:3]))
        plain_ms = float(np.mean([dev_ms[0], dev_ms[3]]))
        eager = [_eager_ms(f) for f in (plain, kern)]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        phase("kernels", f"{name} at B=256 n=128 m=2 b=8: max|kernel-plain| "
                         f"{err:.3e} ({rel:.2e} rel); device time per call "
                         f"(CUDA graph of 20 calls, median of 10 replays, "
                         f"CUDA events; plain, kernel, kernel, plain "
                         f"{', '.join(f'{t:.4f}' for t in dev_ms)} ms): "
                         f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
                         f"eager call with host launch (median of 20): "
                         f"kernel {eager[1]:.4f} ms, plain {eager[0]:.4f} ms")
    return rows


def main_path_phase(prob, controls, pcof, tgt, dev, rows, smi):
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    run = lambda p, pc, **kw: qt.segmented_objective_and_gradient(
        p, controls, pc, tgt, ORDER, **kw)

    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    (j1, guard, _), grad = run(prob, pcof)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = sk.launch_counts()
    # per objective+gradient call: one LHS-kernel launch (the implicit
    # stage matrix LHS(t_{n+1})) and one RHS-kernel launch (the explicit
    # half) per forward step; the backward builds R and L in plain torch
    expected = {"hermite_lhs_matrix": NSTEPS, "hermite_rhs": NSTEPS}
    check(counts == expected, f"launch counts {counts} != {expected}")
    for r in rows:
        r["launches"] = counts[r["name"]]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    obj = (j1 + guard)
    check(obj.shape == (SCENARIOS,) and grad.shape == (SCENARIOS, 60),
          "output shapes")
    check(bool(torch.isfinite(obj).all()) and
          bool(torch.isfinite(grad).all()), "finite objective and gradient")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(prob, pcof)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = float(np.mean(times))
    steps = 2 * NSTEPS * SCENARIOS
    phase("main", f"CNOT3 nsteps={NSTEPS} S={SCENARIOS} f32 kernel route: "
                  f"first call {first_s:.3f} s, then {', '.join(f'{t:.3f}' for t in times)} s "
                  f"-> {steps / sec:.1f} steps/s (2*nsteps*S per call) on "
                  f"{smi}; launches {counts}; peak memory {peak_gb:.2f} GB")

    # f32 plain route and native f64 plain route, scenarios 0-3
    k = 4
    (pj1, pg, _), pgrad = run(prob, pcof[:k], use_kernels=False)
    prob64 = qt.cnot3_problem(nsteps=NSTEPS, solver="schulz",
                              dtype="float64", schulz_iters=48,
                              schulz_warm_budget=0, device=dev)
    (fj1, fg, _), fgrad = run(prob64, pcof[:k], use_kernels=False)
    d_obj = float(((j1 + guard)[:k] - (pj1 + pg)).abs().max())
    d_grad = float(((grad[:k] - pgrad).norm(dim=-1)
                    / pgrad.norm(dim=-1)).max())
    d_obj64 = float(((j1 + guard)[:k] - (fj1 + fg)).abs().max())
    d_grad64 = float(((grad[:k] - fgrad).norm(dim=-1)
                      / fgrad.norm(dim=-1)).max())
    phase("main", f"scenarios 0-3, kernel route vs plain f32 route: "
                  f"|d obj| {d_obj:.3e} (<= {ROUTE_OBJ_TOL:g}), "
                  f"|d grad|/|grad| {d_grad:.3e} (<= {ROUTE_GRAD_TOL:g})")
    phase("main", f"scenarios 0-3, kernel route f32 vs plain f64 route: "
                  f"|d obj| {d_obj64:.3e} (<= {F64_OBJ_TOL:g}), "
                  f"|d grad|/|grad| {d_grad64:.3e} (<= {F64_GRAD_TOL:g}); "
                  f"f64 objective {[round(float(x), 9) for x in fj1 + fg]}")
    check(d_obj <= ROUTE_OBJ_TOL and d_grad <= ROUTE_GRAD_TOL,
          "kernel route vs plain f32 route")
    check(d_obj64 <= F64_OBJ_TOL and d_grad64 <= F64_GRAD_TOL,
          "kernel route vs f64 route")

    res = qt.stage_residuals(prob, controls, pcof[:1], ORDER, sample=8)
    phase("main", f"stage residual, scenario 0, 8 probes: max "
                  f"{res['max']:.3e} mean {res['mean']:.3e} "
                  f"(limit {RESIDUAL_LIMIT:g}; the TPU runs' guard was "
                  f"{TPU_ERA_GUARD:g}, reported, not asserted)")
    check(res["max"] <= RESIDUAL_LIMIT, "stage residual")


def main():
    smi = device_phase()
    import qgd_tpu_torch as qt

    build_phase()
    dev = torch.device("cuda", 0)
    prob = qt.cnot3_problem(nsteps=NSTEPS, solver="schulz", dtype="float32",
                            schulz_iters=48, schulz_warm_budget=0,
                            device=dev)
    controls = tuple(qt.BSpline2Control(10, prob.tf) for _ in range(3))
    pcof = torch.tensor(
        np.random.default_rng(0).standard_normal((SCENARIOS, 60)) * 0.01,
        dtype=torch.float64, device=dev)
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))

    rows = kernel_phase(prob, controls, pcof, dev)
    main_path_phase(prob, controls, pcof, tgt, dev, rows, smi)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:  # report and fail: no phase's failure is hidden
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr, flush=True)
        raise
