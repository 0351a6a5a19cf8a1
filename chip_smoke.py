"""GPU smoke run of qgd_tpu_torch: builds the CUDA stage kernels from the
sources in this checkout, checks each against its plain PyTorch version on
the card at every shape the driven paths give it and times it beside its
bound, its library yardstick and with L2 flushed, then drives the main
path, the optimizer and the batched multistart once each, checks what
comes out, and profiles one shorter call of the main path.

The main path: the CNOT3 objective + exact discrete-adjoint gradient
(3 coupled transmons (4,4,4), real-stacked state 2N = 128, 8 gate-basis
columns, order 4, three BSpline2Control(10) pulses = 60 parameters,
nsteps = 1000, tf = 550), solver="schulz" with warm budget 0 and 3 f32
refinement sweeps, segment length 1, f32 propagation with f64 reductions,
for 256 control-vector scenarios.

The optimize phase: ``optimize_gate`` (scipy L-BFGS-B, 3 iterations, the
plain Lagrange route: one hoisted LHS launch at B = nsteps and one RHS
launch at B = 1 per step and evaluation) on CNOT3 at its published
horizon nsteps = 5500, f32, solver="schulz" with warm budget 0, with the
180-parameter carrier controls (3 x CarrierControl(BSpline2Control(10),
3 sideband frequencies)) and the rotating-frame CNOT target, route checks
at the start point, and a save + resume of the run. The multistart phase:
``optimize_gate_multistart`` on the segmented route, 256 carrier starts,
CNOT3 at nsteps = 1000, 2 iterations.

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
import warnings

import numpy as np
import torch

NSTEPS = 1000
SCENARIOS = 256
TRACE_STEPS = 100  # the profiled call
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
# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): FP32
# outside the tensor cores, and HBM3. The kernels run in plain FP32 FMA.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
# A buffer larger than the 50 MB L2, written between launches to time a
# kernel with its operands cold.
FLUSH_BYTES = 128 * 2 ** 20
# The 1e-7 stage-residual guard of the TPU runs, reported beside ours.
TPU_ERA_GUARD = 1e-7
# Optimize phase (CNOT3 at the published horizon, one control vector) and
# multistart phase (the main path's horizon and scenario count).
OPT_NSTEPS, OPT_ITERS, OPT_BOUND = 5500, 3, 0.02
MS_NSTEPS, MS_STARTS, MS_ITERS = 1000, 256, 2


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


def _cold_ms(fn, flush, calls=20):
    """Device time of one ``fn()`` call with L2 flushed before it: the
    graph of (flush, fn) pairs less the graph of flushes alone."""
    def pair():
        flush()
        fn()
    return _device_ms(pair, calls=calls) - _device_ms(flush, calls=calls)


def _host_us(fn, calls=200):
    """Host time of one eager ``fn()`` call (microseconds): ``calls`` calls
    enqueued back to back, one synchronize at the end, averaged. The
    device work per call is shorter than the host's, so this is the time
    the call costs the host-bound step loop."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _device_kernels(fn):
    """Names of the device activities (kernels, copies, sets) that one
    ``fn()`` call issues, from torch.profiler; ``None`` if the profiler
    records no device activity here."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


def _bound(flops, nbytes):
    """``(bound_ms, bound_by, resource)``: the least time the card could
    take, the larger of the FLOP over the FP32 peak and the bytes over the
    HBM rate."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", "fp32_fma"
    return t_bytes, "bytes", "hbm_bytes"


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


def kernel_phase(prob, controls, pcof, dev, smi):
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    # small shapes, every m the kernels are tested at, ragged tiles included
    for m in (1, 2, 3, 6):
        for B, n, b in ((3, 16, 4), (2, 130, 11), (2, 256, 8)):
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
    phase("kernels", "m in (1, 2, 3, 6) at (B,n,b) = (3,16,4), (2,130,11), "
                     "(2,256,8): "
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

    rows = _kernel_rows(*_main_path_stacks(prob, controls, pcof, dev), dev,
                        smi)
    # the optimize phase's shapes: the hoisted LHS build over all 5500
    # steps (B = 5500) and the explicit half of one control vector (B = 1)
    A, W, dt = _optimize_stacks(dev)
    rows += _kernel_rows(A, W[:1], dt, dev, smi, suffixed=True)
    return rows


def _optimize_stacks(dev):
    """Generator stacks (T, m, 2N, 2N) of every step's implicit side as the
    optimize phase's hoisted build hands them to the LHS kernel (CNOT3,
    nsteps = 5500, the carrier controls at the phase's start point), and
    a state batch (T, 2N, 8)."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.forward import _time_grid

    m = ORDER // 2
    prob, controls, pcof0, _ = _optimize_setup(dev)
    wprob = qt.working_problem(prob)
    _, ts = _time_grid(prob)
    pc = torch.tensor(pcof0, dtype=torch.float64, device=dev)
    P, Q = qt.control_tables(controls, pc, ts[1:], m)
    A = qt.assemble_generator_stack(wprob, P.float(), Q.float(),
                                    m).contiguous()
    rng = np.random.default_rng(3)
    W = torch.tensor(rng.standard_normal((A.shape[0], 128, 8)),
                     dtype=torch.float32, device=dev)
    W = W / W.norm(dim=-2, keepdim=True)
    dt = torch.tensor(prob.tf / prob.nsteps, dtype=torch.float32,
                      device=dev)
    return A, W, dt


def _kernel_rows(A, W, dt, dev, smi, suffixed=False):
    """One JSON row per kernel at these inputs: LHS on ``A`` (B, m, n, n),
    RHS on ``A[:B_rhs]`` and ``W`` (B_rhs, n, b). ``suffixed`` names the
    rows with their batch (the rows of a second shape)."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    m = ORDER // 2
    n = A.shape[-1]
    b = W.shape[-1]
    Ar = A[:W.shape[0]].contiguous()
    f32 = 4
    B_l, B_r = A.shape[0], Ar.shape[0]
    # what each function must do: the LHS one n^3 product per matrix at
    # m = 2, the RHS m(m+1)/2 products of n^2 b; each input read once, each
    # output written once
    work = {"hermite_lhs_matrix": (2 * n ** 3 * B_l * (m - 1),
                                   (A.numel() + B_l * n * n) * f32),
            "hermite_rhs": (m * (m + 1) // 2 * 2 * n * n * b * B_r,
                            (Ar.numel() + 2 * W.numel()) * f32)}
    # the library yardstick of the LHS at m = 2: one cuBLAS batched FP32
    # product, C + (c2/2) At0 At0 with C = c0 I + c1 At0 + (c2/2) At1 on
    # the scaled stack, prepared outside the timed graph
    c = qt.hermite_coefficients(m)
    scales = sk._stack_scales(dt, m, -1.0, dev)
    a0s, a1s = A[:, 0] * scales[0], A[:, 1] * scales[1]
    C = (c[0] * torch.eye(n, device=dev) + c[1] * a0s + (c[2] / 2) * a1s)
    del a1s
    library = lambda: torch.baddbmm(C, a0s, a0s, alpha=c[2] / 2)
    flush_buf = torch.empty(FLUSH_BYTES // f32, dtype=torch.float32,
                            device=dev)
    flush = flush_buf.zero_
    rows = []
    for name, src, replaces, kern, plain, lib, B in (
            ("hermite_lhs_matrix", "qgd_tpu_torch/csrc/lhs.cu",
             "qgd_tpu/ops/pallas_step.py:184",
             lambda: sk.hermite_lhs_matrix_kernel_call(A, dt, m),
             lambda: sk.lhs_matrix_plain(A, dt, m), library, B_l),
            ("hermite_rhs", "qgd_tpu_torch/csrc/rhs.cu",
             "qgd_tpu/ops/pallas_step.py:91",
             lambda: sk.hermite_rhs_kernel_call(Ar, W, dt, m),
             lambda: sk.rhs_plain(Ar, W, dt, m), None, B_r)):
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        del out, ref
        check(rel <= KERNEL_REL_TOL,
              f"{name} at B={B}: {rel:.2e} relative")
        lib_note = ""
        if lib is not None:
            lib_rel = _rel(lib(), sk.lhs_matrix_plain(A, dt, m))
            check(lib_rel <= KERNEL_REL_TOL,
                  f"{name} library yardstick vs plain: {lib_rel:.2e}")
        calls = 20 if B * n * n * f32 < 2 ** 28 else 3
        # (fewer graph-captured calls where each output is large)
        # plain, kernel, kernel, plain (library last, beside them)
        dev_ms = [_device_ms(f, calls=calls) for f in (plain, kern, kern,
                                                       plain)]
        ms = float(np.mean(dev_ms[1:3]))
        plain_ms = float(np.mean([dev_ms[0], dev_ms[3]]))
        library_ms = (_device_ms(lib, calls=calls) if lib is not None
                      else None)
        cold_ms = _cold_ms(kern, flush, calls=calls)
        bound_ms, bound_by, resource = _bound(*work[name])
        eager = [_eager_ms(f) for f in (plain, kern)]
        host_us = _host_us(kern, calls=200 if calls == 20 else 20)
        kernels = _device_kernels(kern)
        row = {"name": f"{name}[B={B}]" if suffixed else name,
               "route": "cuda", "source": src,
               "replaces": replaces, "launches": 0,
               "shape": {"B": B, "n": n, "m": m,
                         **({"b": b} if name == "hermite_rhs" else {})},
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_resource": resource, "share": bound_ms / ms,
               "library_ms": library_ms, "cold_ms": cold_ms,
               "device_launches": None if kernels is None else len(kernels),
               "eager_ms": eager[1], "host_us": host_us}
        if lib is None:
            row["library_note"] = ("no single PyTorch call: W2 depends on "
                                   "W1, two dependent products")
        else:
            lib_note = (f"; library (torch.baddbmm on the pre-scaled "
                        f"stack) {library_ms:.4f} ms, {lib_rel:.1e} rel vs "
                        f"plain")
        rows.append(row)
        flops, nbytes = work[name]
        warm = (" (share > 1: the operands came from L2)"
                if bound_ms / ms > 1 else "")
        phase("kernels", f"{name} at B={B} n={n} m={m} b={b}: max|kernel-"
                         f"plain| {err:.3e} ({rel:.2e} rel); device time per "
                         f"call (CUDA graph of {calls} calls, median of 10 "
                         f"replays, CUDA events; plain, kernel, kernel, plain "
                         f"{', '.join(f'{t:.4f}' for t in dev_ms)} ms): "
                         f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                         f"{lib_note}; cold L2 (a {FLUSH_BYTES >> 20} MiB "
                         f"write before each call, subtracted) {cold_ms:.4f} "
                         f"ms; bound {bound_ms:.4f} ms by {resource} "
                         f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB "
                         f"at {PEAK_FP32_FLOPS / 1e12:g} TFLOP/s, "
                         f"{PEAK_HBM_BYTES_PER_S / 1e12:g} TB/s), share "
                         f"{bound_ms / ms:.3f}{warm}; eager call with host "
                         f"launch (median of 20): kernel {eager[1]:.4f} ms, "
                         f"plain {eager[0]:.4f} ms; host time per call "
                         f"{host_us:.1f} us; device activities per call "
                         f"{row['device_launches']}: {kernels}; {smi}")
    del flush_buf
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
        if r["name"] in counts:
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
                  f"|d grad|/|grad| {d_grad:.3e} (<= {ROUTE_GRAD_TOL:g}); "
                  f"{smi}")
    phase("main", f"scenarios 0-3, kernel route f32 vs plain f64 route: "
                  f"|d obj| {d_obj64:.3e} (<= {F64_OBJ_TOL:g}), "
                  f"|d grad|/|grad| {d_grad64:.3e} (<= {F64_GRAD_TOL:g}); "
                  f"f64 objective {[round(float(x), 9) for x in fj1 + fg]}; "
                  f"{smi}")
    check(d_obj <= ROUTE_OBJ_TOL and d_grad <= ROUTE_GRAD_TOL,
          "kernel route vs plain f32 route")
    check(d_obj64 <= F64_OBJ_TOL and d_grad64 <= F64_GRAD_TOL,
          "kernel route vs f64 route")

    res = qt.stage_residuals(prob, controls, pcof[:1], ORDER, sample=8)
    phase("main", f"stage residual, scenario 0, 8 probes: max "
                  f"{res['max']:.3e} mean {res['mean']:.3e} "
                  f"(limit {RESIDUAL_LIMIT:g}; the TPU runs' guard was "
                  f"{TPU_ERA_GUARD:g}, reported, not asserted); {smi}")
    check(res["max"] <= RESIDUAL_LIMIT, "stage residual")


def _optimize_setup(dev):
    """The optimize phase's problem, carrier controls (180 parameters),
    start point (uniform in +-OPT_BOUND/10, seed 0) and target, as
    examples/cnot3_optimize_gate.py sets them up."""
    import qgd_tpu_torch as qt

    prob = qt.cnot3_problem(nsteps=OPT_NSTEPS, solver="schulz",
                            dtype="float32", schulz_warm_budget=0,
                            device=dev)
    controls = [qt.CarrierControl(qt.BSpline2Control(10, prob.tf), f)
                for f in qt.cnot3_carrier_frequencies()]
    pcof0 = np.random.default_rng(0).uniform(-OPT_BOUND / 10, OPT_BOUND / 10,
                                             180)
    return prob, controls, pcof0, qt.cnot3_target()


def _grad_rel(x, ref):
    return float((x - ref).norm() / ref.norm())


def optimize_phase(rows, dev, smi):
    """optimize_gate on CNOT3 at nsteps = 5500 with the carrier controls:
    the routes at the start point, OPT_ITERS L-BFGS-B iterations with their
    kernel launches counted, and a save + resume."""
    import os
    import tempfile

    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    prob, controls, pcof0, tgt = _optimize_setup(dev)
    kw = dict(ridge_penalty_strength=1e-2)
    oag = lambda p, **k: qt.objective_and_gradient(p, controls, pcof0, tgt,
                                                   ORDER, **kw, **k)
    # the first call under CUDA's sync debug mode: each operation that
    # waits for the device warns, so the count shows whether the step
    # loops (2 x 5500 steps) wait anywhere
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            (j1, g, r), grad = oag(prob)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message).lower() for w in caught)
    obj = float(j1 + g + r)
    check(np.isfinite(obj) and bool(torch.isfinite(grad).all()),
          "finite objective and gradient at the start point")
    (pj1, pg, pr), pgrad = oag(prob, use_kernels=False)
    prob64 = qt.cnot3_problem(nsteps=OPT_NSTEPS, device=dev)  # f64, "lu"
    (fj1, fg, fr), fgrad = oag(prob64)
    (sj1, sg, sr), sgrad = qt.segmented_objective_and_gradient(
        prob, controls, pcof0, tgt, ORDER, **kw)
    d_obj, d_grad = abs(obj - float(pj1 + pg + pr)), _grad_rel(grad, pgrad)
    d_obj64, d_grad64 = abs(obj - float(fj1 + fg + fr)), _grad_rel(grad,
                                                                     fgrad)
    d_seg = _grad_rel(grad, sgrad)
    phase("optimize", f"CNOT3 nsteps={OPT_NSTEPS}, 180 carrier parameters, "
                      f"start point: objective {obj:.9f} (f64 lu route "
                      f"{float(fj1 + fg + fr):.9f}); kernel route vs plain "
                      f"f32 route |d obj| {d_obj:.3e} (<= {ROUTE_OBJ_TOL:g}),"
                      f" |d grad|/|grad| {d_grad:.3e} (<= {ROUTE_GRAD_TOL:g});"
                      f" vs f64 lu route {d_obj64:.3e} (<= {F64_OBJ_TOL:g}), "
                      f"{d_grad64:.3e} (<= {F64_GRAD_TOL:g}); plain route "
                      f"vs segmented L=1 route gradient {d_seg:.3e} (<= "
                      f"{ROUTE_GRAD_TOL:g}); operations that waited for the "
                      f"device in one evaluation: {syncs}; {smi}")
    check(d_obj <= ROUTE_OBJ_TOL and d_grad <= ROUTE_GRAD_TOL,
          "optimize: kernel route vs plain f32 route")
    check(d_obj64 <= F64_OBJ_TOL and d_grad64 <= F64_GRAD_TOL,
          "optimize: kernel route vs f64 lu route")
    check(d_seg <= ROUTE_GRAD_TOL, "optimize: plain vs segmented gradient")
    # a wait per step would count at least nsteps; the setup's few
    # host-to-device copies of small constants are a fixed few dozen
    check(syncs < OPT_NSTEPS // 10, f"optimize: {syncs} device waits in "
                                    f"one evaluation")

    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "cnot3")
        sk.reset_launch_counts()
        hist = qt.optimize_gate(prob, controls, pcof0, tgt, order=ORDER,
                                pcof_L=-OPT_BOUND, pcof_U=OPT_BOUND,
                                maxIter=OPT_ITERS, print_level=0,
                                filename=base, **kw)
        torch.cuda.synchronize()
        counts = sk.launch_counts()
        n_eval = len(hist.obj_value)
        # per evaluation: one hoisted LHS launch over all steps, one RHS
        # launch per forward step; the adjoint sweep launches none
        expected = {"hermite_lhs_matrix": n_eval,
                    "hermite_rhs": OPT_NSTEPS * n_eval}
        check(counts == expected, f"optimize launch counts {counts} != "
                                  f"{expected}")
        for row in rows:
            kname = row["name"].split("[")[0]
            if row["name"] != kname:
                row["launches"] = counts[kname]
                row["launches_per_evaluation"] = counts[kname] // n_eval
        secs = np.diff([0.0] + hist.wall_time)
        phase("optimize", f"optimize_gate, L-BFGS-B maxIter={OPT_ITERS}, "
                          f"bounds +-{OPT_BOUND}: {n_eval} evaluations, "
                          f"objective per evaluation "
                          f"{[round(v, 9) for v in hist.obj_value]}, seconds "
                          f"per evaluation {[round(float(t), 3) for t in secs]} "
                          f"(median {float(np.median(secs)):.3f} s); kernel "
                          f"launches {counts} = per evaluation 1 LHS "
                          f"(B={OPT_NSTEPS}) and {OPT_NSTEPS} RHS (B=1); "
                          f"{smi}")
        check(n_eval > 1 and min(hist.obj_value[1:]) < hist.obj_value[0],
              "optimize: a later objective below the first")
        check(all(np.isfinite(hist.obj_value)), "finite objectives")
        resumed = qt.resume_optimization(base, device=dev, maxIter=1,
                                         print_level=0)
        torch.cuda.synchronize()
        check(len(resumed.obj_value) > n_eval and resumed.iter_count ==
              list(range(len(resumed.obj_value))),
              "resume_optimization carries the iteration count on")
        phase("optimize", f"save_setup + resume_optimization: "
                          f"{len(resumed.obj_value) - n_eval} more "
                          f"evaluations, iterations {n_eval}.."
                          f"{resumed.iter_count[-1]}, last objective "
                          f"{resumed.obj_value[-1]:.9f}; {smi}")


def multistart_phase(dev, smi):
    """optimize_gate_multistart on the segmented route: MS_STARTS carrier
    starts on CNOT3 at nsteps = MS_NSTEPS, MS_ITERS iterations."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    prob = qt.cnot3_problem(nsteps=MS_NSTEPS, solver="schulz",
                            dtype="float32", schulz_iters=48,
                            schulz_warm_budget=0, device=dev)
    controls = [qt.CarrierControl(qt.BSpline2Control(10, prob.tf), f)
                for f in qt.cnot3_carrier_frequencies()]
    starts = np.random.default_rng(1).uniform(
        -OPT_BOUND / 10, OPT_BOUND / 10, (MS_STARTS, 180))
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    # no box bounds: the Armijo search accepts the unclipped point, so
    # clipping after it would forfeit the decrease it guarantees
    pcofs, objs = qt.optimize_gate_multistart(
        prob, controls, starts, qt.cnot3_target(), order=ORDER,
        maxIter=MS_ITERS, gradient_route="segmented", print_level=0)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = sk.launch_counts()
    check(objs.shape == (MS_ITERS, MS_STARTS) and np.isfinite(objs).all()
          and bool(torch.isfinite(pcofs).all()), "multistart: finite values")
    med = np.median(objs, axis=1)
    # each forward pass launches the LHS kernel once per step
    passes = counts["hermite_lhs_matrix"] / MS_NSTEPS
    phase("multistart", f"optimize_gate_multistart, segmented route, "
                        f"S={MS_STARTS} carrier starts, CNOT3 nsteps="
                        f"{MS_NSTEPS}, {MS_ITERS} iterations: objective min "
                        f"{[round(float(v), 9) for v in objs.min(axis=1)]}, "
                        f"median {[round(float(v), 9) for v in med]} per "
                        f"iteration; {sec:.3f} s, {passes:g} forward passes "
                        f"(gradient calls and line-search probes), launches "
                        f"{counts}; {smi}")
    check(med[-1] < med[0], "multistart: the median objective falls")


def trace_phase(pcof, tgt, dev, smi):
    """torch.profiler over one main-path call at nsteps = TRACE_STEPS (the
    same step size, S = SCENARIOS): the device's busy share of the call and
    where its device time goes."""
    import qgd_tpu_torch as qt
    from torch.profiler import ProfilerActivity, profile

    prob = qt.cnot3_problem(tf=550.0 * TRACE_STEPS / NSTEPS,
                            nsteps=TRACE_STEPS, solver="schulz",
                            dtype="float32", schulz_iters=48,
                            schulz_warm_budget=0, device=dev)
    controls = tuple(qt.BSpline2Control(10, prob.tf) for _ in range(3))
    run = lambda: qt.segmented_objective_and_gradient(prob, controls, pcof,
                                                      tgt, ORDER)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, ops = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
        elif e.name.startswith("aten::"):
            ops += 1
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    phase("trace", f"one call, nsteps={TRACE_STEPS} S={SCENARIOS}, "
                   f"torch.profiler on, {smi}: wall {wall_ms:.1f} ms, device "
                   f"kernels {busy_ms:.1f} ms (busy {busy_ms / wall_ms:.3f}, "
                   f"idle {1 - busy_ms / wall_ms:.3f}), {ops} aten events, nested "
                   f"calls included ({ops / TRACE_STEPS:.0f} per step); top "
                   f"device time: "
                   + "; ".join(f"{name[:60]} {t:.2f} ms" for name, t in top))


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

    rows = kernel_phase(prob, controls, pcof, dev, smi)
    main_path_phase(prob, controls, pcof, tgt, dev, rows, smi)
    optimize_phase(rows, dev, smi)
    multistart_phase(dev, smi)
    trace_phase(pcof, tgt, dev, smi)

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
