"""GPU smoke run of qgd_tpu_torch: builds the CUDA stage kernels from the
sources in this checkout, checks each against its plain PyTorch version on
the card at every shape the driven paths give it and times it beside its
bound, its library yardstick and with L2 flushed, then drives the main
path, the optimizer, the batched multistart and the matrix-free GMRES
route once each, and checks what comes out. The device trace of the main
path's calls, split by the segmented route's spans, is the benchmark's
(``qgdbench/run.py --trace 1``).

The main path: the CNOT3 objective + exact discrete-adjoint gradient
(3 coupled transmons (4,4,4), real-stacked state 2N = 128, 8 gate-basis
columns, order 4, three BSpline2Control(10) pulses = 60 parameters,
nsteps = 1000, tf = 550), solver="schulz" with warm budget 0 and 3 f32
refinement sweeps, segment length 1, f32 propagation with f64 reductions,
for 256 control-vector scenarios: per step the LHS and RHS kernels in the
forward and the pair kernel (the backward's R and L from one recursion;
at m = 2 its product on the tensor cores in split TF32, the kernels phase
holding it against the float64 pair beside the LHS kernel's error) in
the backward, the step loops in blocks of 100 steps, each block
program captured once as a CUDA graph and replayed. The main phase keeps
one SegmentGraphs across four calls (the first captures, the second runs
under CUDA's sync debug mode), holds every replayed call bit for bit to
the capturing one and reports capture seconds, graph nodes, device
waits and memory.

The optimize phase: ``optimize_gate`` (scipy L-BFGS-B, 3 iterations, the
plain Lagrange route: one hoisted LHS launch at B = nsteps and one RHS
launch at B = 1 per step and evaluation) on CNOT3 at its published
horizon nsteps = 5500, f32, solver="schulz" with warm budget 0, with the
180-parameter carrier controls (3 x CarrierControl(BSpline2Control(10),
3 sideband frequencies)) and the rotating-frame CNOT target, route checks
at the start point, and a save + resume of the run. The multistart phase:
``optimize_gate_multistart`` on the segmented route, 256 carrier starts,
CNOT3 at nsteps = 1000, 2 iterations.

The segmented phase: the main path's call at segment length L = 40
(``choose_segments(1000)``: re-forward per segment, the LHS and pair
kernels at B = 256 x 40, segment programs replayed as CUDA graphs)
against L = 1, with the main phase's graph report, then CNOT3 at nsteps = 5500 with 256 scenarios on the automatic
segment rule. The prefix phase: ``optimize_gate(gradient_route=
"prefix")`` on the optimize phase's setup (the LHS kernel at B = 275 per
segment, both signs), its gradient at the start point held against the
plain route's and float64. The L-BFGS phase: ``optimize_gate(method=
"lbfgs")`` (on-device L-BFGS, zoom line search, projected bounds) on the
same setup, prefix route. The forced-gradient phase, in float64 on the
card: the general-L segmented gradient of Rabi at nsteps = 10240 held
against forward-mode AD (``eval_grad_forced``); then forward mode through
the f32 kernels (each kernel's forward-mode rule): the forced gradient of
CNOT3 at 100 steps against float64 and against the Lagrange gradient, and
the AD Hessian (``eval_hessian``) against float64, with the launches each
call made. The main phase holds the stage residual at the milestone's
1e-7.

The gmres phase: ``solver="gmres"`` with the diagonal preconditioner,
whose GMRES operator is the RHS kernel at step sign -1: the main path's
configuration (S = 256, nsteps = 1000, 20 Arnoldi steps) on the segmented
route held against float64 LU, with launches by sign, and the autograd
gradient of a 20-step slice (the transposed solves); ``optimize_gate`` on
the optimize phase's setup. The gmres_large phase: CNOT3's transmons at 8
levels each (512 levels, 2N = 1024: the RHS kernel's level path), whose
stage matrices are never built, single-device and level-sharded
(``tp_forward_history``) on a one-rank NCCL group.

The order8 phase: the main path's call at order 8 (m = 4: the LHS
kernel's staged launch plus two level launches per call, the RHS kernel at
m = 4) held against float64 LU. The large_dense phase: the 512-level
system on the dense f32 Schulz route (the LHS kernel at 2N = 1024, B = 20
per segment at L = 20 and B = 1 per step at L = 1, and the explicit half)
held against float64 LU. The wide phase: both kernels against their plain
versions at shapes whose state levels outgrow a block's shared memory.

The sharded phase (``qgd_tpu_torch.parallel.sharded``): (a) the main
path's call through ``batched_objective_and_grad`` on a 1 x 1 mesh of one
NCCL rank against the unsharded call; (c) three ``multichip_train_step``
steps on that mesh; (b) ``sharded_objective_and_grad`` with the 8 gate
columns split 4 + 4 over two processes on the one card (gloo carrying
CUDA tensors: NCCL takes one rank per device), the RHS kernel at b = 4,
against one process. The utils phase: ``get_histories`` on Rabi (orders 2
and 4, 3 refinements, Richardson slopes), ``verlet_forward`` on CNOT3
carried through the Juqbox fields against the order-8 Hermite forward,
and ``estimate_N_timesteps`` on CNOT3.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases kernels,order8,large_dense,gmres_large
    python3 chip_smoke.py --phases kernels,sharded,utils

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit; exits non-zero, printing no result, without them. Imports no
JAX. The last line is a JSON object with "ok" and the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

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
# Stage residual |rhs - LHS w| / |rhs| at 8 sampled steps, in float64
# (a broken stage solve sits at 1e-2 or worse). The milestone's guard, that
# of the North star and the JAX bench's runs, holds every phase at order 4:
# the main path, its configuration at other horizons and segment lengths,
# GMRES and 2N = 1024. Order 8 keeps a wider limit (PERF.md section 2: its
# f32 solve sits at the milestone's guard).
MILESTONE_RESIDUAL = 1e-7
ORDER8_RESIDUAL = 1e-6
# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): FP32
# outside the tensor cores, dense TF32 on them, and HBM3. The LHS and RHS
# kernels run in plain FP32 FMA; the pair kernel at m = 2 does its product
# as three TF32 passes (split TF32), whose time at the TF32 peak its rows
# give beside the bound.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_PER_S = 3.35e12
# The pair kernel's precision on the main path's stack: its error against
# the float64 pair over max |ref| at most PAIR_F64_RATIO times the LHS
# kernel's on L (plain FP32 FMA, the same inputs) and at most PAIR_F64_TOL.
PAIR_F64_RATIO, PAIR_F64_TOL = 2.0, 1e-6
# A buffer larger than the 50 MB L2, written between launches to time a
# kernel with its operands cold.
FLUSH_BYTES = 128 * 2 ** 20
# Optimize phase (CNOT3 at the published horizon, one control vector) and
# multistart phase (the main path's horizon and scenario count).
OPT_NSTEPS, OPT_ITERS, OPT_BOUND = 5500, 3, 0.02
MS_NSTEPS, MS_STARTS, MS_ITERS = 1000, 256, 2
# L-BFGS phase iterations; the forced-gradient gate's horizon, and its
# tolerances (tests/test_segmented.py's VERDICT gate: adjoint vs forced
# rtol 1e-13, atol 1e-14 * max(1, |g|max)).
LBFGS_ITERS = 3
FORCED_NSTEPS = 10240
# The forced gradient in f32 (forward mode through the kernels): CNOT3 at
# the main path's step 0.55 (tf = 550 at 100 steps is a step of 5.5, where
# the warm-budget-0 Schulz solve does not converge even in float64).
FORCED32_NSTEPS, FORCED32_TF = 100, 55.0
# The prefix route's segment length at OPT_NSTEPS: choose_segments(5500,
# target_len=256) gives 20 segments.
PREFIX_L = 275
# f64 prefix route vs f64 plain LU route: the same maps, exact inverses,
# multiplied in another association (1e-11 at 24 steps on the CPU); 1e-9
# leaves room for roundoff growth over 5500 steps, a wrong term shows at
# 1e-6 or more. The f32 prefix route is held against f64 at F64_*_TOL,
# as the JAX package holds it (tests/test_prefix.py): its f32 products
# drift from f64 several times as far as the serial route's solves.
PREFIX_F64_TOL = 1e-9
FORCED_RTOL, FORCED_ATOL = 1e-13, 1e-14
# GMRES phase: Arnoldi steps per stage solve; the autograd slice's steps;
# L-BFGS-B iterations of its optimize_gate and the Arnoldi steps there (at
# dt = 0.1 the diagonally preconditioned stage converges in 3: float64
# residual 2.5e-16, float32 4e-8 from 2 on, on the CPU, as the reference's
# tolerance-driven GMRES would stop); the 512-level system's steps.
# The large system's f32 history against f64 LU (O(1) entries, 200 steps
# of f32 roundoff), and the level-sharded history against the
# single-device one (the same GMRES, plain products in place of the
# kernel: f32 roundoff only).
GMRES_ITERS, GMRES_AD_STEPS, GMRES_OPT_ITERS, GMRES_OPT_BUDGET = 20, 20, 2, 4
LARGE_NSTEPS = 200
GMRES_TRACE_STEPS = 10
LARGE_F64_TOL, TP_TOL = 1e-4, 1e-5
# order8 phase: the main path at order 8 (m = 4: the LHS kernel's staged
# launch plus two level launches). large_dense phase: the 512-level system
# on the dense Schulz route, at segment length LARGE_L (n_segments = 10)
# and on the automatic rule.
ORDER8 = 8
LARGE_L = 20
# sharded phase. (a) the main path's call on a 1 x 1 mesh of one NCCL rank
# against the unsharded call: the same arithmetic (a one-rank sum is the
# identity), so only a library's choice of summation order between two
# calls could part them. (b) the 8 gate columns split 4 + 4 over two
# processes on the one card against one process: b = 4 in the RHS kernel
# and in cuBLAS's products where one process has b = 8, f32 roundoff over
# 1000 steps. NCCL takes one rank per device, so the two ranks on one card
# go through gloo, which carries CUDA tensors. (c) TRAIN_STEPS gradient
# steps at TRAIN_LR (at 1e-4 the mean objective of the 256 scenarios rose
# at the third step, PERF.md).
SHARD_OBJ_TOL, SHARD_GRAD_TOL, SPLIT_REL_TOL = 1e-6, 1e-5, 1e-5
SPLIT_BACKEND = "gloo"
SPLIT_TIMEOUT_S = 600
TRAIN_STEPS, TRAIN_LR = 3, 2e-5
# utils phase: get_histories on Rabi at tf = 2 pi with a constant pulse,
# orders 2 and 4 from 32 steps, 3 refinements, each order's Richardson
# slope within tests/test_convergence.py's 0.55 of the order; the
# Stormer-Verlet baseline on CNOT3 carried through the Juqbox fields, at
# tf = 20 and 400, 800, 1600 steps against the order-8 Hermite solution
# at 1600 (slope 2 within the same 0.55); the step estimate at the
# published horizon with each control at the optimize phase's bound.
RICH_ORDERS, RICH_REFINE, RICH_BASE = (2, 4), 3, 32
SLOPE_TOL = 0.55
VERLET_TF, VERLET_NSTEPS = 20.0, (400, 800, 1600)
# chunked phase. (a) the optimize phase's setup on the host-chunked route:
# CHUNK_SEGMENTS segments of 100 steps, chunks of at most CHUNK_CAP steps
# (11 segments: 5 chunks), against the segmented route at the same
# segment count (the same segment programs, captured within its one call;
# the gradient summed over other cuts), both against float64 LU at
# F64_*_TOL. (b) float64 LU at
# CHUNK_F64_NSTEPS steps (tf = 55), chunked against segmented. (c) CNOT3 at
# LONG_NSTEPS steps of dt = 1e-2 on the chunked route, chunks of at most
# LONG_CAP steps; 10 x as many steps as well if (c)'s rate projects them
# inside LONG_BUDGET_S. (d) OPT_CHUNK_ITERS L-BFGS-B iterations of
# optimize_gate(max_dispatch_steps=CHUNK_CAP), saved, and a resume from the
# files alone.
CHUNK_SEGMENTS, CHUNK_CAP = 55, 1100
CHUNK_OBJ_TOL, CHUNK_GRAD_TOL, CHUNK_F64_TOL = 1e-6, 1e-5, 1e-12
CHUNK_F64_NSTEPS, CHUNK_F64_SEGMENTS, CHUNK_F64_CAP = 550, 10, 110
LONG_NSTEPS, LONG_CAP, LONG_BUDGET_S = 55_000, 5500, 60.0
OPT_CHUNK_ITERS = 2
# Shapes no kernel took before the level path of the RHS kernel: (B, m, n,
# b) = 2N = 2048 at order 4, a 4-qubit gate's 16 columns at 512 levels,
# order 10 and order 12 at 512 levels (the last ragged past 1024).
WIDE_SHAPES = ((1, 2, 2048, 8), (1, 2, 1024, 16), (1, 5, 1024, 8),
               (1, 6, 2000, 8))


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


def _device_waits(fn):
    """``(fn(), waits)``: one call under CUDA's sync debug mode, where each
    operation that waits for the device warns; ``waits`` counts them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message).lower() for w in caught)


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


def _main_path_stacks(prob, controls, pcof, dev, order=ORDER):
    """Generator stacks (S, m, 2N, 2N) and states (S, 2N, 8) as the main
    path hands them to the kernels at this order (f32, step 500's left
    end)."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.forward import _time_grid

    m = order // 2
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

    A, W, dt = _main_path_stacks(prob, controls, pcof, dev)
    _pair_precision(A, dt, smi)
    # the main path's shapes: both forward kernels at B = 256 and the
    # backward's pair at the same batch (one launch per backward step)
    rows = _kernel_rows(A, W, dt, dev, smi, "main", pair=True)
    # the order8 phase's: the main path at order 8 (m = 4), the LHS as the
    # staged launch plus levels 2 and 3
    A8, _, _ = _main_path_stacks(prob, controls, pcof, dev, order=ORDER8)
    rows += _kernel_rows(A8, W, dt, dev, smi, "order8", "B=256,m=4",
                         rhs_tag="B=256,m=4", pair=True,
                         pair_tag="B=256,m=4")
    del A8
    # the gmres phase's shapes: the GMRES operator (RHS kernel at sign -1)
    # on the main path's stacks, on their transposed copy (the reverse
    # solve of the autograd gradient) and at 512 levels (the level path)
    rows += _kernel_rows(A, W, dt, dev, smi, "gmres", lhs=False,
                         rhs_sign=-1.0, rhs_tag="B=256,sign=-1")
    rows += _kernel_rows(A.transpose(-1, -2).contiguous(), W, dt, dev, smi,
                         "gmres_ad", lhs=False, rhs_sign=-1.0,
                         rhs_tag="B=256,sign=-1,transposed")
    del A, W
    A, W, dt = _large_stacks(dev)
    rows += _kernel_rows(A, W, dt, dev, smi, "gmres_large", lhs=False,
                         rhs_sign=-1.0, rhs_tag="B=1,n=1024,sign=-1")
    # the large_dense phase's: the same system's implicit-stage build at
    # one step (L = 1, the automatic rule) and at one segment of L =
    # LARGE_L (B = 20), and its explicit half
    rows += _kernel_rows(A, W, dt, dev, smi, "large_dense", "B=1,n=1024",
                         rhs_tag="B=1,n=1024,sign=+1", pair=True,
                         pair_tag="B=1,n=1024")
    del A, W
    A, _, dt = _large_stacks(dev, steps=LARGE_L)
    rows += _kernel_rows(A, None, dt, dev, smi, "large_dense",
                         f"B={LARGE_L},n=1024", pair=True,
                         pair_tag=f"B={LARGE_L},n=1024")
    del A
    # the segmented phase's shape: one segment's implicit-stage build at
    # L = 40 for the 256 scenarios (B = 10240), and its backward's pair
    A, dt = _segment_stacks(prob, controls, pcof, dev)
    rows += _kernel_rows(A, None, dt, dev, smi, "segmented", "B=10240",
                         pair=True, pair_tag="B=10240")
    del A
    # the optimize phase's shapes: the hoisted LHS build over all 5500
    # steps (B = 5500) and the explicit half of one control vector (B = 1);
    # the prefix phase's: one segment's R (sign +1) and M (sign -1) at
    # L = 275 (B = 275)
    A, W, dt = _optimize_stacks(dev)
    rows += _kernel_rows(A, W[:1], dt, dev, smi, "optimize", "B=5500")
    # its adjoint's pairs at the nsteps - 1 interior points, hoisted: one
    # launch at B = 5499
    rows += _kernel_rows(A[:-1].contiguous(), None, dt, dev, smi,
                         "optimize", lhs=False, pair=True,
                         pair_tag=f"B={OPT_NSTEPS - 1}")
    # the gmres phase's optimize_gate: the GMRES operator of one control
    # vector (B = 1)
    rows += _kernel_rows(A, W[:1], dt, dev, smi, "gmres_optimize",
                         lhs=False, rhs_sign=-1.0, rhs_tag="B=1,sign=-1")
    # and its adjoint's pair of one control vector per step (GMRES hoists
    # no stage)
    rows += _kernel_rows(A[:1].contiguous(), None, dt, dev, smi,
                         "gmres_optimize", lhs=False, pair=True,
                         pair_tag="B=1")
    rows += _kernel_rows(A[:PREFIX_L].contiguous(), None, dt, dev, smi,
                         "prefix", "B=275,sign=-1", pair=True,
                         pair_tag="B=275")
    rows += _kernel_rows(A[:PREFIX_L].contiguous(), None, dt, dev, smi,
                         "prefix", "B=275,sign=+1", sign=1.0)
    # the chunked phase's (a): one segment's implicit-stage build (B = 100,
    # the first segment's right endpoints) and the explicit half of one
    # control vector, both launched by graph replays
    L = OPT_NSTEPS // CHUNK_SEGMENTS
    rows += _kernel_rows(A[:L].contiguous(), W[:1], dt, dev, smi, "chunked",
                         f"B={L},chunked", rhs_tag="B=1,chunked", pair=True,
                         pair_tag=f"B={L},chunked")
    del A, W
    # its (c): one segment of CNOT3 at LONG_NSTEPS steps (B = 250)
    A, dt = _long_stacks(dev)
    rows += _kernel_rows(A, None, dt, dev, smi, "chunked_long",
                         f"B={A.shape[0]},chunked", pair=True,
                         pair_tag=f"B={A.shape[0]},chunked")
    del A
    # the sharded phase's (b): one rank's 4 of the 8 gate columns on the
    # plain route for one control vector: the hoisted LHS build over the
    # 1000 steps (B = 1000) and the explicit half at b = 4 (B = 1)
    A, W, dt = _split_stacks(prob, controls, pcof, dev)
    rows += _kernel_rows(A, W, dt, dev, smi, "sharded", "B=1000",
                         rhs_tag="B=1,b=4")
    rows += _kernel_rows(A[:-1].contiguous(), None, dt, dev, smi,
                         "sharded", lhs=False, pair=True,
                         pair_tag=f"B={NSTEPS - 1}")
    return rows


def _pair_precision(A, dt, smi):
    """The split-TF32 pair kernel against the float64 pair on the main
    path's stack, beside the LHS kernel (FP32 FMA) on L; fails unless the
    pair's error is within PAIR_F64_RATIO times the LHS kernel's and
    PAIR_F64_TOL."""
    from qgd_tpu_torch.ops import stage_kernels as sk

    R, L = sk.hermite_stage_pair_kernel_call(A, dt, 2)
    lhs = sk.hermite_lhs_matrix_kernel_call(A, dt, 2)
    R64, L64 = sk.stage_pair_plain(A.double(), dt.double(), 2)
    pair_abs, pair_err = _errs((R.double(), L.double()), (R64, L64))
    lhs_abs, lhs_err = _errs(lhs.double(), L64)
    plain = tuple(x.double() for x in sk.stage_pair_plain(A, dt, 2))
    plain_err = _errs(plain, (R64, L64))[1]
    phase("kernels", f"pair precision on the main path's stack (B = "
                     f"{A.shape[0]}, CNOT3 step 500 of {NSTEPS}): split-TF32 "
                     f"pair kernel vs the float64 pair max|err| {pair_abs:.3e}"
                     f" ({pair_err:.3e} of max|ref|, R and L); LHS kernel "
                     f"(FP32 FMA) on L {lhs_abs:.3e} ({lhs_err:.3e}); ratio "
                     f"{pair_err / lhs_err:.3f} (limit {PAIR_F64_RATIO:g}, "
                     f"and <= {PAIR_F64_TOL:g}); the plain f32 pair (cuBLAS "
                     f"FP32) {plain_err:.3e}; {smi}")
    check(pair_err <= PAIR_F64_RATIO * lhs_err and pair_err <= PAIR_F64_TOL,
          f"pair vs float64 {pair_err:.3e}, LHS kernel {lhs_err:.3e}")


def _short_kernel(name):
    """A profiler kernel name without return type, namespaces and
    arguments: ``stage_pair_tf32_kernel<64, true>``."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    base, lt, args = head.strip().removeprefix("void ").partition("<")
    return base.rsplit("::", 1)[-1] + lt + args


def wide_phase(dev, smi):
    """Both kernels against their plain versions at WIDE_SHAPES, the
    shapes whose state levels outgrew the shared memory of the RHS
    kernel's earlier general path; correctness only."""
    from qgd_tpu_torch.ops import stage_kernels as sk

    errs = []
    for B, m, n, b in WIDE_SHAPES:
        rng = np.random.default_rng(7 * m + n + b)
        # entries ~ 1/sqrt(n): the stack's norms stay O(1) at every n
        A = torch.tensor(rng.standard_normal((B, m, n, n)) / np.sqrt(n),
                         dtype=torch.float32, device=dev)
        W = torch.tensor(rng.standard_normal((B, n, b)), dtype=torch.float32,
                         device=dev)
        dt = torch.tensor(0.1, dtype=torch.float32, device=dev)
        e_r = _rel(sk.hermite_rhs_kernel_call(A, W, dt, m),
                   sk.rhs_plain(A, W, dt, m))
        e_l = _rel(sk.hermite_lhs_matrix_kernel_call(A, dt, m),
                   sk.lhs_matrix_plain(A, dt, m))
        torch.cuda.synchronize()
        errs.append(f"(B,m,n,b)={(B, m, n, b)}: rhs {e_r:.2e} lhs {e_l:.2e}")
        check(e_r <= KERNEL_REL_TOL and e_l <= KERNEL_REL_TOL,
              f"kernel vs plain at {(B, m, n, b)}: rhs {e_r:.2e} lhs "
              f"{e_l:.2e}")
        del A, W
    phase("wide", f"kernel vs plain (<= {KERNEL_REL_TOL:g} relative) "
                  f"{'; '.join(errs)}; {smi}")


def _large_problem(dev, dtype="float32", solver="gmres"):
    """CNOT3's transmons with 8 levels each: 512 levels, 2N = 1024, the
    2 x 2 x 2 essential block (8 gate columns), CNOT3's frequencies, frame
    and Kerr matrix; LARGE_NSTEPS steps of dt = 0.1; GMRES with the
    diagonal preconditioner (Schulz: the main path's settings), and 3 x
    BSpline2Control(10)."""
    import qgd_tpu_torch as qt

    freqs = 2 * np.pi * np.array([4.10336, 4.81831, 7.8447])
    xi = 2 * np.pi * np.array([0.2198, 0.2252, 0.001])
    x12, x13, x23 = 2 * np.pi * np.array([0.01, 0.001, 0.001])
    kerr = np.array([[xi[0], x12, x13], [x12, xi[1], x23],
                     [x13, x23, xi[2]]])
    kw = dict(solver=solver, dtype=dtype, device=dev)
    if solver == "gmres":
        kw.update(gmres_iters=GMRES_ITERS, preconditioner_type="diagonal")
    elif solver == "schulz":    # the main path's solver settings
        kw.update(schulz_iters=48, schulz_warm_budget=0)
    prob = qt.DispersiveProblem((8, 8, 8), (2, 2, 2), freqs, freqs, kerr,
                                LARGE_NSTEPS * 0.1, LARGE_NSTEPS, **kw)
    controls = tuple(qt.BSpline2Control(10, prob.tf) for _ in range(3))
    return prob, controls


def _large_stacks(dev, steps=0):
    """The generator stack (1, m, 1024, 1024) of the large system at its
    middle step, as its GMRES operator hands it to the RHS kernel (or, with
    ``steps``, the stacks (steps, m, 1024, 1024) of the first segment's
    right endpoints, as one segment's implicit-stage build hands them to
    the LHS kernel), and a state block (1, 1024, 8)."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.forward import _time_grid

    m = ORDER // 2
    prob, controls = _large_problem(dev)
    _, ts = _time_grid(prob)
    pc = _main_pcof(dev)[:1]
    t = (ts[1:steps + 1] if steps else
         ts[LARGE_NSTEPS // 2:LARGE_NSTEPS // 2 + 1])
    P, Q = qt.control_tables(controls, pc, t, m)
    A = qt.assemble_generator_stack(qt.working_problem(prob),
                                    P[0].float(), Q[0].float(),
                                    m).contiguous()
    rng = np.random.default_rng(4)
    W = torch.tensor(rng.standard_normal((1, 1024, 8)), dtype=torch.float32,
                     device=dev)
    W = W / W.norm(dim=-2, keepdim=True)
    dt = torch.tensor(prob.tf / prob.nsteps, dtype=torch.float32,
                      device=dev)
    return A, W, dt


def _main_pcof(dev):
    """The main phase's seed-0 control vectors."""
    return torch.tensor(
        np.random.default_rng(0).standard_normal((SCENARIOS, 60)) * 0.01,
        dtype=torch.float64, device=dev)


def _segment_stacks(prob, controls, pcof, dev):
    """Generator stacks (S*L, m, 2N, 2N) of the first segment's right
    endpoints at L = 40, as the segmented route hands them to the LHS
    kernel (S = 256 scenarios, f32)."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.forward import _time_grid

    m = ORDER // 2
    L = NSTEPS // qt.choose_segments(NSTEPS)
    wprob = qt.working_problem(prob)
    _, ts = _time_grid(prob)
    P, Q = qt.control_tables(controls, pcof, ts[1:L + 1], m)
    A = qt.assemble_generator_stack(wprob, P.float(), Q.float(), m)
    dt = torch.tensor(prob.tf / prob.nsteps, dtype=torch.float32,
                      device=dev)
    return A.reshape((-1,) + A.shape[2:]).contiguous(), dt


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


def _long_problem(dev):
    """The chunked phase's (c): CNOT3 at LONG_NSTEPS steps (tf = 550, dt =
    1e-2), f32 Schulz warm 0, the optimize phase's carrier controls."""
    import qgd_tpu_torch as qt

    prob = qt.cnot3_problem(nsteps=LONG_NSTEPS, solver="schulz",
                            dtype="float32", schulz_warm_budget=0,
                            device=dev)
    return prob, [qt.CarrierControl(qt.BSpline2Control(10, prob.tf), f)
                  for f in qt.cnot3_carrier_frequencies()]


def _long_stacks(dev):
    """Generator stacks (L, m, 2N, 2N) of the first segment's right
    endpoints of the chunked phase's (c) at its automatic segment length,
    as one segment's implicit-stage build hands them to the LHS kernel."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.forward import _time_grid

    prob, controls = _long_problem(dev)
    _, _, pcof0, _ = _optimize_setup(dev)
    L = LONG_NSTEPS // qt.choose_segments(LONG_NSTEPS)
    _, ts = _time_grid(prob)
    pc = torch.tensor(pcof0, dtype=torch.float64, device=dev)
    P, Q = qt.control_tables(controls, pc, ts[1:L + 1], ORDER // 2)
    A = qt.assemble_generator_stack(qt.working_problem(prob), P.float(),
                                    Q.float(), ORDER // 2).contiguous()
    dt = torch.tensor(prob.tf / prob.nsteps, dtype=torch.float32,
                      device=dev)
    return A, dt


def _split_stacks(prob, controls, pcof, dev):
    """Generator stacks (T, m, 2N, 2N) of every step's implicit side for
    the main path's scenario 0, as the plain route's hoisted build hands
    them to the LHS kernel, and one rank's half of the gate columns (1,
    2N, 4)."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.forward import _time_grid

    m = ORDER // 2
    wprob = qt.working_problem(prob)
    _, ts = _time_grid(prob)
    P, Q = qt.control_tables(controls, pcof[0], ts[1:], m)
    A = qt.assemble_generator_stack(wprob, P.float(), Q.float(),
                                    m).contiguous()
    rng = np.random.default_rng(4)
    W = torch.tensor(rng.standard_normal((1, 128, 4)), dtype=torch.float32,
                     device=dev)
    W = W / W.norm(dim=-2, keepdim=True)
    dt = torch.tensor(prob.tf / prob.nsteps, dtype=torch.float32,
                      device=dev)
    return A, W, dt


def _kernel_rows(A, W, dt, dev, smi, driven_by, tag=None, sign=-1.0,
                 lhs=True, rhs_sign=1.0, rhs_tag=None, pair=False,
                 pair_tag=None):
    """One JSON row per kernel at these inputs: LHS on ``A`` (B, m, n, n)
    with step sign ``sign`` (-1: the implicit-stage matrix LHS(t), +1: the
    explicit-side R(t)) unless ``lhs`` is false, RHS on ``A[:B_rhs]`` and
    ``W`` (B_rhs, n, b) with step sign ``rhs_sign`` (+1: the explicit
    half, -1: the GMRES operator) unless ``W`` is None, and with ``pair``
    the backward's pair (R, L) on ``A``. ``driven_by`` names the phase
    whose launches the rows report; ``tag`` (``rhs_tag``, ``pair_tag``,
    default ``B=...``) is appended to the names of a second shape's LHS
    (RHS, pair) rows."""
    from qgd_tpu_torch.ops import stage_kernels as sk

    m = A.shape[1]
    n = A.shape[-1]
    f32 = 4
    B_l = A.shape[0]
    # what each function must do: the LHS (and the pair) m(m-1)/2 products
    # of n^3 per matrix (level j has j), the RHS m(m+1)/2 products of n^2
    # b; each input read once, each output written once (the pair's two)
    products = m * (m - 1) // 2 * 2 * n ** 3 * B_l
    work = {"hermite_lhs_matrix": (products, (A.numel() + B_l * n * n) * f32),
            "hermite_stage_pair": (products,
                                   (A.numel() + 2 * B_l * n * n) * f32)}
    if W is not None:
        b = W.shape[-1]
        Ar = A[:W.shape[0]].contiguous()
        B_r = Ar.shape[0]
        work["hermite_rhs"] = (m * (m + 1) // 2 * 2 * n * n * b * B_r,
                               (Ar.numel() + 2 * W.numel()) * f32)
    cases = []
    if lhs:
        yardstick, is_chain = _lhs_yardstick(A, dt, sign, dev)
        cases.append(("hermite_lhs_matrix", "qgd_tpu_torch/csrc/lhs.cu",
                      "qgd_tpu/ops/pallas_step.py:184",
                      lambda: sk.hermite_lhs_matrix_kernel_call(A, dt, m,
                                                                sign),
                      lambda: sk.lhs_matrix_plain(A, dt, m, sign),
                      yardstick, B_l, is_chain))
    if pair:
        cases.append(("hermite_stage_pair", "qgd_tpu_torch/csrc/pair.cu",
                      "qgd_tpu/forward.py:158",
                      lambda: sk.hermite_stage_pair_kernel_call(A, dt, m),
                      lambda: sk.stage_pair_plain(A, dt, m),
                      _pair_yardstick(A, dt, dev), B_l, True))
    flush_buf = torch.empty(FLUSH_BYTES // f32, dtype=torch.float32,
                            device=dev)
    flush = flush_buf.zero_
    rows = []
    if W is not None:
        # the entry each driven path calls: the GMRES operator launches
        # without the autograd.Function
        entry = (sk.hermite_rhs_kernel_call if rhs_sign == 1.0
                 else sk.hermite_rhs_kernel_launch)
        cases.append(("hermite_rhs", "qgd_tpu_torch/csrc/rhs.cu",
                      "qgd_tpu/ops/pallas_step.py:91",
                      lambda: entry(Ar, W, dt, m, rhs_sign),
                      lambda: sk.rhs_plain(Ar, W, dt, m, rhs_sign), None,
                      B_r, False))
    for name, src, replaces, kern, plain, lib, B, is_chain in cases:
        err, rel = _errs(kern(), plain())
        torch.cuda.synchronize()
        check(rel <= KERNEL_REL_TOL,
              f"{name} at B={B}: {rel:.2e} relative")
        lib_note = ""
        if lib is not None:
            lib_rel = _errs(lib(), plain())[1]
            check(lib_rel <= KERNEL_REL_TOL,
                  f"{name} library yardstick vs plain: {lib_rel:.2e}")
        calls = 20 if B * n * n * f32 < 2 ** 28 else 3
        # (fewer graph-captured calls where each output is large)
        # plain, kernel, kernel, plain (library last, beside them)
        dev_ms = [_device_ms(f, calls=calls) for f in (plain, kern, kern,
                                                       plain)]
        ms = float(np.mean(dev_ms[1:3]))
        plain_ms = float(np.mean([dev_ms[0], dev_ms[3]]))
        lib_ms = _device_ms(lib, calls=calls) if lib is not None else None
        # a chain of calls is no single library call: its time goes in
        # the note, library_ms stays null
        library_ms = None if is_chain else lib_ms
        cold_ms = _cold_ms(kern, flush, calls=calls)
        bound_ms, bound_by, resource = _bound(*work[name])
        eager = [_eager_ms(f) for f in (plain, kern)]
        host_us = _host_us(kern, calls=200 if calls == 20 else 20)
        kernels = _device_kernels(kern)
        row_tag = {"hermite_rhs": rhs_tag or f"B={B}",
                   "hermite_stage_pair": pair_tag or f"B={B}"}.get(name, tag)
        tagged = tag or rhs_tag or pair_tag
        row = {"name": f"{name}[{row_tag}]" if tagged else name,
               "route": "cuda", "source": src,
               "replaces": replaces, "launches": 0, "phase": driven_by,
               "shape": {"B": B, "n": n, "m": m,
                         **({"b": b, "sign": int(rhs_sign)}
                            if name == "hermite_rhs"
                            else {"sign": 1 if name == "hermite_stage_pair"
                                  else int(sign)})},
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_resource": resource, "share": bound_ms / ms,
               "library_ms": library_ms, "cold_ms": cold_ms,
               "device_launches": None if kernels is None else len(kernels),
               "eager_ms": eager[1], "host_us": host_us}
        tf32_note = ""
        if kernels is not None:
            row["kernel"] = ", ".join(_short_kernel(k) for k in kernels)
            if "stage_pair_tf32_kernel" in row["kernel"]:
                # pair.cu launched csrc/pair_tf32.cuh: three TF32 passes
                # per product on the tensor cores; the bound stays the
                # function's own work (FP32 products, HBM bytes)
                row["source"] = "qgd_tpu_torch/csrc/pair_tf32.cuh"
                tf32_ms = 3 * work[name][0] / PEAK_TF32_FLOPS * 1e3
                tf32_note = (f"; its 3 TF32 passes {tf32_ms:.4f} ms at "
                             f"{PEAK_TF32_FLOPS / 1e12:g} TFLOP/s, beside "
                             f"the bound")
        if lib is None:
            row["library_note"] = ("no single PyTorch call: W2 depends on "
                                   "W1, two dependent products")
        elif name == "hermite_stage_pair":
            row["library_note"] = (
                f"no single PyTorch call returns the pair: the chain of "
                f"{m * (m - 1) // 2} cuBLAS products (torch.baddbmm per "
                f"product on the pre-scaled stack) and the two epilogue "
                f"passes R = E + O, L = E - O took {lib_ms:.4f} ms")
            lib_note = (f"; library: none, chain of cuBLAS products and "
                        f"the two epilogue passes {lib_ms:.4f} ms, "
                        f"{lib_rel:.1e} rel vs plain")
        elif is_chain:
            row["library_note"] = (
                f"no single PyTorch call at m = {m}: D_(j+1) depends on "
                f"D_j; the chain of {m * (m - 1) // 2} cuBLAS products "
                f"(torch.baddbmm per product on the pre-scaled stack) and "
                f"its level sums took {lib_ms:.4f} ms")
            lib_note = (f"; library: none, chain of per-level cuBLAS "
                        f"products {lib_ms:.4f} ms, {lib_rel:.1e} rel vs "
                        f"plain")
        else:
            lib_note = (f"; library (torch.baddbmm on the pre-scaled "
                        f"stack) {library_ms:.4f} ms, {lib_rel:.1e} rel vs "
                        f"plain")
        rows.append(row)
        flops, nbytes = work[name]
        warm = (" (share > 1: the operands came from L2)"
                if bound_ms / ms > 1 else "")
        what = (f"b={b} sign={int(rhs_sign):+d}" if name == "hermite_rhs"
                else "(R, L)" if name == "hermite_stage_pair"
                else f"sign={int(sign):+d}")
        phase("kernels", f"{name} at B={B} n={n} m={m} {what}: max|kernel-"
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
                         f"{bound_ms / ms:.3f}{warm}{tf32_note}; eager call "
                         f"with host launch (median of 20): kernel "
                         f"{eager[1]:.4f} ms, "
                         f"plain {eager[0]:.4f} ms; host time per call "
                         f"{host_us:.1f} us; device activities per call "
                         f"{row['device_launches']}: {kernels}; {smi}")
    del flush_buf
    return rows


def _errs(out, ref):
    """``(max |out - ref|, that over max |ref|)``, the largest over the
    outputs where the function returns a pair."""
    pairs = zip(out, ref) if isinstance(out, tuple) else [(out, ref)]
    errs = [(float((o - r).abs().max()), float(r.abs().max()))
            for o, r in pairs]
    return max(e for e, _ in errs), max(e / r for e, r in errs)


def _pair_yardstick(A, dt, dev):
    """The pair's library chain: on the stack scaled at +dt, one
    ``torch.baddbmm`` per product of the recursion (D_(j+1) depends on
    D_j), the even and odd level sums E and O, and the two epilogue
    passes R = E + O, L = E - O."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    m, n = A.shape[1], A.shape[-1]
    c = qt.hermite_coefficients(m)
    As = A * sk._stack_scales(dt, m, 1.0, dev)[None, :, None, None]
    E0 = c[0] * torch.eye(n, device=dev)

    def chain():
        D = [None, As[:, 0]]
        for j in range(1, m):
            acc = As[:, j]
            for i in range(1, j + 1):
                acc = torch.baddbmm(acc, As[:, j - i], D[i])
            D.append(acc / (j + 1))
        E = E0 + sum(c[j] * D[j] for j in range(2, m + 1, 2))
        O = sum(c[j] * D[j] for j in range(1, m + 1, 2))
        return torch.add(E, O), torch.sub(E, O)
    return chain


def _lhs_yardstick(A, dt, sign, dev):
    """``(fn, is_chain)``: at m = 2 one cuBLAS batched FP32 product, C +
    (c2/2) At0 At0 with C = c0 I + c1 At0 + (c2/2) At1 on the scaled stack,
    prepared outside the timed graph (the library call); at m >= 3 no
    single call computes the recursion, and ``fn`` runs it as a chain of
    one ``torch.baddbmm`` per product on the pre-scaled stack."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    m, n = A.shape[1], A.shape[-1]
    c = qt.hermite_coefficients(m)
    scales = sk._stack_scales(dt, m, sign, dev)
    if m == 2:
        a0s, a1s = A[:, 0] * scales[0], A[:, 1] * scales[1]
        C = (c[0] * torch.eye(n, device=dev) + c[1] * a0s
             + (c[2] / 2) * a1s)
        del a1s
        return (lambda: torch.baddbmm(C, a0s, a0s, alpha=c[2] / 2)), False
    As = A * scales[None, :, None, None]
    eye = torch.eye(n, device=dev)

    def chain():
        D = [None, As[:, 0]]
        out = c[0] * eye + c[1] * As[:, 0]
        for j in range(1, m):
            acc = As[:, j]
            for i in range(1, j + 1):
                acc = torch.baddbmm(acc, As[:, j - i], D[i])
            D.append(acc / (j + 1))
            out = out + c[j + 1] * D[-1]
        return out
    return chain, True


def _replayed_calls(call, graphs, expected, what, calls=4):
    """``calls`` calls of a segmented route that keeps its programs in
    ``graphs``: the first runs each program eagerly once and captures it,
    the second runs under CUDA's sync debug mode (device waits), the rest
    are timed. Each call's launches are held to ``expected`` (replays
    counted); every later call's objective to the capturing call's, bit
    for bit, its gradient within 1e-15 relative. Memory: the peak of
    allocated tensors, and that above the call's start; the growth of
    reserved memory over the calls (the graphs' pools)."""
    from qgd_tpu_torch.ops import stage_kernels as sk

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    outs, secs, peaks, above = [], [], [], []
    for i in range(calls):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        if i == 1:
            out, waits = _device_waits(call)
        else:
            out = call()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        above.append(peaks[-1] - base)
        counts = sk.launch_counts()
        check(counts == expected, f"{what} launch counts, call {i}: "
                                  f"{counts} != {expected}")
        if i == 0:
            first = graphs.stats()
        outs.append(out)
    (j1, g, _), grad = outs[0]
    bitwise = all(torch.equal(o[0][0] + o[0][1], j1 + g) for o in outs[1:])
    d_grad = max(_grad_rel(o[1], grad) for o in outs[1:])
    check(bitwise and d_grad <= 1e-15,
          f"{what}: replayed calls vs the capturing call: objective "
          f"bit-identical {bitwise}, |d grad|/|grad| {d_grad:.3e}")
    return dict(out=outs[0], secs=secs, waits=waits, peaks=peaks,
                above=above, counts=counts, first=first,
                stats=graphs.stats(), d_grad=d_grad,
                grown=torch.cuda.memory_reserved() - reserved0)


def _program_nodes(graphs, cls, prob, m, L, S):
    """Nodes of the graphs of the forward and backward programs ``graphs``
    keeps for ``cls`` (their buffers as the last run left them)."""
    from qgd_tpu_torch.ops import stage_kernels as sk

    progs = graphs.programs(cls, prob, m, L, S)
    nodes = {k: _graph_nodes(getattr(progs, f"_{k}"))
             for k in ("forward", "backward")}
    sk.reset_launch_counts()      # the captures' launches ran nowhere
    return nodes


def _graph_report(r, nodes, steps, S):
    """The phase line's part on a route's graphs, from
    :func:`_replayed_calls`."""
    steady = float(np.mean(r["secs"][2:]))
    return (f"seconds per call: first (runs each program once eagerly and "
            f"captures it) {r['secs'][0]:.3f}, under sync debug mode "
            f"{r['secs'][1]:.3f}, then "
            f"{', '.join(f'{t:.3f}' for t in r['secs'][2:])} (mean "
            f"{steady:.3f}: {2 * steps * S / steady:.1f} counted steps/s, "
            f"{steady / (2 * steps) * 1e6:.1f} us per step and pass); "
            f"capture {r['first']['capture_seconds']:.3f} s for "
            f"{r['first']['graphs']} graphs of {nodes['forward']} (fwd) and "
            f"{nodes['backward']} (bwd) nodes; replays over the "
            f"{len(r['secs'])} calls {r['stats']['replays']}; replayed calls "
            f"vs the capturing call: objective bit-identical, |d grad|/|grad|"
            f" {r['d_grad']:.3e}; device waits per call {r['waits']}; peak "
            f"allocated {[round(p / 1e9, 3) for p in r['peaks']]} GB "
            f"({[round(p / 1e9, 3) for p in r['above']]} above each call's "
            f"start), reserved memory grew {r['grown'] / 1e9:.3f} GB over "
            f"the calls; launches per call {r['counts']}")


def main_path_phase(prob, controls, pcof, tgt, dev, rows, smi):
    import qgd_tpu_torch as qt
    from qgd_tpu_torch import segmented

    run = lambda p, pc, **kw: qt.segmented_objective_and_gradient(
        p, controls, pc, tgt, ORDER, **kw)
    graphs = qt.SegmentGraphs()
    # per objective+gradient call: one LHS-kernel launch (the implicit
    # stage matrix LHS(t_{n+1})) and one RHS-kernel launch (the explicit
    # half) per forward step, one pair-kernel launch (R(t_n), L(t_n)) per
    # backward step, in blocks of K steps replayed as CUDA graphs
    expected = {"hermite_lhs_matrix": NSTEPS, "hermite_rhs": NSTEPS,
                "hermite_stage_pair": NSTEPS}
    r = _replayed_calls(lambda: run(prob, pcof, graphs=graphs), graphs,
                        expected, "main")
    (j1, guard, _), grad = r["out"]
    for row in rows:
        if row["name"] in r["counts"]:
            row["launches"] = r["counts"][row["name"]]
    K = segmented._block_length(NSTEPS)
    nodes = _program_nodes(graphs, segmented._BlockPrograms, prob,
                           ORDER // 2, K, SCENARIOS)

    obj = (j1 + guard)
    check(obj.shape == (SCENARIOS,) and grad.shape == (SCENARIOS, 60),
          "output shapes")
    check(bool(torch.isfinite(obj).all()) and
          bool(torch.isfinite(grad).all()), "finite objective and gradient")
    phase("main", f"CNOT3 nsteps={NSTEPS} S={SCENARIOS} f32 kernel route, "
                  f"L = 1 in {NSTEPS // K} blocks of K = {K} steps: "
                  + _graph_report(r, nodes, NSTEPS, SCENARIOS) + f"; {smi}")

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
                  f"(limit {MILESTONE_RESIDUAL:g}); {smi}")
    check(res["max"] <= MILESTONE_RESIDUAL, "stage residual")


def _set_launches(rows, driven_by, counts, tag=None):
    """Give the rows of phase ``driven_by`` (those whose name carries
    ``tag``, when given) the launches of their kernel in ``counts``."""
    for r in rows:
        if r["phase"] == driven_by and (tag is None or tag in r["name"]):
            r["launches"] = counts[r["name"].split("[")[0]]


def order8_phase(prob, controls, pcof, tgt, dev, rows, smi):
    """The main path's call at order 8 (m = 4): launches, seconds per call,
    scenarios 0-3 against float64 LU, and the stage residual."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    run = lambda p, pc, **kw: qt.segmented_objective_and_gradient(
        p, controls, pc, tgt, ORDER8, **kw)
    graphs = qt.SegmentGraphs()     # the second call replays the first's
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        (j1, g, _), grad = run(prob, pcof, graphs=graphs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = sk.launch_counts()
    # per call, as at order 4: one LHS-kernel call (staged launch plus the
    # level launches j = 2, 3) and one RHS-kernel call per forward step,
    # one pair-kernel call (the same launches) per backward step
    expected = {"hermite_lhs_matrix": NSTEPS, "hermite_rhs": NSTEPS,
                "hermite_stage_pair": NSTEPS}
    check(counts == expected, f"order8 launch counts {counts} != "
                              f"{expected}")
    _set_launches(rows, "order8", counts)
    obj = j1 + g
    check(obj.shape == (SCENARIOS,) and grad.shape == (SCENARIOS, 60)
          and bool(torch.isfinite(obj).all() and torch.isfinite(grad).all()),
          "order8: finite objective and gradient of the expected shapes")
    k = 4
    prob64 = qt.cnot3_problem(nsteps=NSTEPS, device=dev)    # f64, "lu"
    (fj1, fg, _), fgrad = run(prob64, pcof[:k])
    d_obj, d_grad = _scenario_deltas(obj[:k], grad[:k], fj1 + fg, fgrad)
    res = qt.stage_residuals(prob, controls, pcof[:1], ORDER8, sample=8)
    phase("order8", f"CNOT3 nsteps={NSTEPS} S={SCENARIOS} f32 kernel route "
                    f"at order {ORDER8}: seconds per call (the first "
                    f"captures, the second replays) "
                    f"{[round(t, 3) for t in secs]}; launches per call "
                    f"{counts}; scenarios 0-3 vs the f64 lu route: |d obj| "
                    f"{d_obj:.3e} (<= {F64_OBJ_TOL:g}), |d grad|/|grad| "
                    f"{d_grad:.3e} (<= {F64_GRAD_TOL:g}); f64 objective "
                    f"{[round(float(x), 9) for x in fj1 + fg]}; stage "
                    f"residual, scenario 0, 8 probes: max {res['max']:.3e} "
                    f"mean {res['mean']:.3e} (limit {ORDER8_RESIDUAL:g}); "
                    f"{smi}")
    check(d_obj <= F64_OBJ_TOL and d_grad <= F64_GRAD_TOL,
          "order8: kernel route vs f64 lu route")
    check(res["max"] <= ORDER8_RESIDUAL, "order8: stage residual")


def large_dense_phase(pcof, dev, rows, smi):
    """The 512-level system (2N = 1024, 8 columns, S = 1, LARGE_NSTEPS
    steps) on the dense route, f32 Schulz with the main path's settings:
    objective and gradient at segment length LARGE_L and on the automatic
    rule, against float64 LU, with the stage residual."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk
    from qgd_tpu_torch.segmented import _segment_count

    prob, controls = _large_problem(dev, solver="schulz")
    n2 = prob.real_system_size
    rng = np.random.default_rng(5)
    tgt = (rng.standard_normal((n2 // 2, 8))
           + 1j * rng.standard_normal((n2 // 2, 8)))
    pc = pcof[:1]
    n_seg = LARGE_NSTEPS // LARGE_L
    n_auto = _segment_count(prob, 0, 1)
    out = {}
    for ns in (n_seg, n_auto):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        (j1, g, _), grad = qt.segmented_objective_and_gradient(
            prob, controls, pc, tgt, ORDER, n_segments=ns)
        torch.cuda.synchronize()
        out[ns] = (j1 + g, grad, time.perf_counter() - t0,
                   torch.cuda.max_memory_allocated(), sk.launch_counts())
    # forward and re-forward launch the LHS kernel once per segment (at
    # B = L) and the RHS kernel once per step, the backward the pair kernel
    # once per segment; at L = 1 the forward alone runs, one of each per
    # step, and the backward one pair per step
    passes = {n_seg: 2, n_auto: 1 if n_auto == LARGE_NSTEPS else 2}
    for ns, (_, _, _, _, counts) in out.items():
        expected = {"hermite_lhs_matrix": passes[ns] * ns,
                    "hermite_rhs": passes[ns] * LARGE_NSTEPS,
                    "hermite_stage_pair": ns}
        check(counts == expected, f"large_dense launch counts at "
                                  f"n_segments={ns}: {counts} != {expected}")
    _set_launches(rows, "large_dense", out[n_seg][4], f"B={LARGE_L},")
    _set_launches(rows, "large_dense", out[n_auto][4],
                  f"B={LARGE_NSTEPS // n_auto},")
    prob64, _ = _large_problem(dev, dtype="float64", solver="lu")
    t0 = time.perf_counter()
    (fj1, fg, _), fgrad = qt.segmented_objective_and_gradient(
        prob64, controls, pc, tgt, ORDER)
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    res = qt.stage_residuals(prob, controls, pc, ORDER, sample=8)
    deltas = {ns: _scenario_deltas(o[0], o[1], fj1 + fg, fgrad)
              for ns, o in out.items()}
    phase("large_dense", f"512 levels (2N = {n2}, 8 columns), nsteps="
                         f"{LARGE_NSTEPS}, dt=0.1, S=1, f32 schulz (warm "
                         f"budget 0, 3 sweeps): "
                         + "; ".join(
                             f"n_segments={ns} (L={LARGE_NSTEPS // ns}): "
                             f"{o[2]:.3f} s, peak memory {o[3] / 1e9:.3f} "
                             f"GB, launches {o[4]}, vs the f64 lu route "
                             f"|d obj| {deltas[ns][0]:.3e}, |d grad|/|grad| "
                             f"{deltas[ns][1]:.3e}"
                             for ns, o in out.items())
                         + f" (limits {F64_OBJ_TOL:g}, {F64_GRAD_TOL:g}; "
                           f"f64 lu {t64:.3f} s, objective "
                           f"{float((fj1 + fg)[0]):.9f}); stage residual, 8 "
                           f"probes: max {res['max']:.3e} mean "
                           f"{res['mean']:.3e} (limit "
                           f"{MILESTONE_RESIDUAL:g}); {smi}")
    for ns, o in out.items():
        check(bool(torch.isfinite(o[0]).all() and torch.isfinite(o[1]).all())
              and o[1].shape == (1, 60), f"large_dense n_segments={ns}: "
                                         f"finite values of the shape")
        check(deltas[ns][0] <= F64_OBJ_TOL and deltas[ns][1] <= F64_GRAD_TOL,
              f"large_dense n_segments={ns}: f32 schulz vs f64 lu")
    check(res["max"] <= MILESTONE_RESIDUAL, "large_dense: stage residual")


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
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    prob, controls, pcof0, tgt = _optimize_setup(dev)
    kw = dict(ridge_penalty_strength=1e-2)
    oag = lambda p, **k: qt.objective_and_gradient(p, controls, pcof0, tgt,
                                                   ORDER, **kw, **k)
    # the first call under CUDA's sync debug mode: the count shows whether
    # the step loops (2 x 5500 steps) wait anywhere
    ((j1, g, r), grad), syncs = _device_waits(lambda: oag(prob))
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
        # launch per forward step, one hoisted pair launch over the
        # adjoint's interior points
        expected = {"hermite_lhs_matrix": n_eval,
                    "hermite_rhs": OPT_NSTEPS * n_eval,
                    "hermite_stage_pair": n_eval}
        check(counts == expected, f"optimize launch counts {counts} != "
                                  f"{expected}")
        for row in rows:
            if row["phase"] == "optimize":
                kname = row["name"].split("[")[0]
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
                          f"(B={OPT_NSTEPS}), {OPT_NSTEPS} RHS (B=1) and 1 "
                          f"pair (B={OPT_NSTEPS - 1}); "
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
    return dict(obj=obj, grad=grad, obj64=float(fj1 + fg + fr), grad64=fgrad,
                secs=secs)


def _scenario_deltas(obj, grad, ref_obj, ref_grad):
    """``(max |d obj|, max |d grad|/|grad|)`` over scenarios."""
    return (float((obj - ref_obj).abs().max()),
            float(((grad - ref_grad).norm(dim=-1)
                   / ref_grad.norm(dim=-1)).max()))


def segmented_phase(prob, controls, pcof, tgt, dev, rows, smi):
    """The main path at segment length L = 40 against L = 1 (seconds per
    call, the capturing call apart, capture seconds, graph nodes, device
    waits and memory), then CNOT3 at nsteps = OPT_NSTEPS with the
    scenarios of the main path on the automatic segment rule."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch import segmented
    from qgd_tpu_torch.ops import stage_kernels as sk
    from qgd_tpu_torch.segmented import _auto_segments

    n_seg = qt.choose_segments(NSTEPS)
    L = NSTEPS // n_seg
    # per call at L = 40: forward and re-forward each launch the LHS kernel
    # once per segment (at S*L) and the RHS kernel once per step (at S),
    # the backward the pair kernel once per segment (at S*L); at L = 1 the
    # main phase's counts
    expected = {n_seg: {"hermite_lhs_matrix": 2 * n_seg,
                        "hermite_rhs": 2 * NSTEPS,
                        "hermite_stage_pair": n_seg},
                NSTEPS: {"hermite_lhs_matrix": NSTEPS, "hermite_rhs": NSTEPS,
                         "hermite_stage_pair": NSTEPS}}
    runs, graphs = {}, {}
    for ns in (NSTEPS, n_seg):
        graphs[ns] = qt.SegmentGraphs()
        runs[ns] = _replayed_calls(
            lambda: qt.segmented_objective_and_gradient(
                prob, controls, pcof, tgt, ORDER, n_segments=ns,
                graphs=graphs[ns]), graphs[ns], expected[ns],
            f"segmented n_segments={ns}", calls=4 if ns == n_seg else 3)
    (j1, g, _), grad = runs[n_seg]["out"]
    (j1_1, g_1, _), grad1 = runs[NSTEPS]["out"]
    obj, obj1 = j1 + g, j1_1 + g_1
    _set_launches(rows, "segmented", runs[n_seg]["counts"])
    nodes = _program_nodes(graphs[n_seg], segmented._SegmentPrograms, prob,
                           ORDER // 2, L, SCENARIOS)
    check(bool(torch.isfinite(obj).all() and torch.isfinite(grad).all()),
          "segmented: finite objective and gradient")
    d_obj, d_grad = _scenario_deltas(obj, grad, obj1, grad1)
    steady1 = float(np.mean(runs[NSTEPS]["secs"][2:]))
    phase("segmented", f"CNOT3 nsteps={NSTEPS} S={SCENARIOS}: L={L} "
                       f"(n_segments={n_seg}) vs L=1: |d obj| {d_obj:.3e} "
                       f"(<= {ROUTE_OBJ_TOL:g}), |d grad|/|grad| "
                       f"{d_grad:.3e} (<= {ROUTE_GRAD_TOL:g}); L={L}: "
                       + _graph_report(runs[n_seg], nodes, NSTEPS, SCENARIOS)
                       + f"; L=1 seconds per call "
                       f"{[round(t, 3) for t in runs[NSTEPS]['secs']]} "
                       f"(replayed {steady1:.3f}), peak allocated "
                       f"{max(runs[NSTEPS]['peaks']) / 1e9:.3f} GB; {smi}")
    check(d_obj <= ROUTE_OBJ_TOL and d_grad <= ROUTE_GRAD_TOL,
          "segmented: L=40 vs L=1")

    # the published horizon for the main path's scenarios: L = 1 would
    # hold (T+1) states and (T+2) multipliers of 1 MiB each
    prob_l = qt.cnot3_problem(nsteps=OPT_NSTEPS, solver="schulz",
                              dtype="float32", schulz_iters=48,
                              schulz_warm_budget=0, device=dev)
    controls_l = tuple(qt.BSpline2Control(10, prob_l.tf) for _ in range(3))
    n_auto = _auto_segments(prob_l, OPT_NSTEPS, SCENARIOS)
    check(n_auto < OPT_NSTEPS, f"auto rule at {OPT_NSTEPS} steps: L = 1")
    per_state = SCENARIOS * 128 * 8 * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    (j1, g, _), grad = qt.segmented_objective_and_gradient(
        prob_l, controls_l, pcof, tgt, ORDER)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expected = {"hermite_lhs_matrix": 2 * n_auto,
                "hermite_rhs": 2 * OPT_NSTEPS,
                "hermite_stage_pair": n_auto}
    check(counts == expected, f"long-horizon launch counts {counts} != "
                              f"{expected}")
    check(bool(torch.isfinite(j1 + g).all() and torch.isfinite(grad).all()),
          "long horizon: finite objective and gradient")
    k = 4
    (rj1, rg, _), rgrad = qt.segmented_objective_and_gradient(
        prob_l, controls_l, pcof[:k], tgt, ORDER, n_segments=OPT_NSTEPS)
    d_obj, d_grad = _scenario_deltas((j1 + g)[:k], grad[:k], rj1 + rg, rgrad)
    res = qt.stage_residuals(prob_l, controls_l, pcof[:1], ORDER, sample=8)
    phase("segmented", f"CNOT3 nsteps={OPT_NSTEPS} S={SCENARIOS}, automatic "
                       f"rule: n_segments={n_auto} (L={OPT_NSTEPS // n_auto})"
                       f", {sec:.3f} s, peak memory {peak / 1e9:.3f} GB "
                       f"(L=1 would store the trajectory "
                       f"{(OPT_NSTEPS + 1) * per_state / 1e9:.3f} GB and the "
                       f"multipliers {(OPT_NSTEPS + 2) * per_state / 1e9:.3f}"
                       f" GB); launches per call {counts}; scenarios 0-3 vs "
                       f"the L=1 route: |d obj| {d_obj:.3e}, |d grad|/|grad| "
                       f"{d_grad:.3e}; stage residual, scenario 0, 8 probes: "
                       f"max {res['max']:.3e} mean {res['mean']:.3e} (limit "
                       f"{MILESTONE_RESIDUAL:g}); {smi}")
    check(d_obj <= ROUTE_OBJ_TOL and d_grad <= ROUTE_GRAD_TOL,
          "long horizon: automatic L vs L=1")
    check(res["max"] <= MILESTONE_RESIDUAL, "long horizon: stage residual")


def prefix_phase(rows, start, dev, smi):
    """optimize_gate(gradient_route="prefix") on the optimize phase's setup:
    the gradient at the start point against the plain route's and float64,
    launches per evaluation, OPT_ITERS L-BFGS-B iterations."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    prob, controls, pcof0, tgt = _optimize_setup(dev)
    kw = dict(ridge_penalty_strength=1e-2)
    n_seg = qt.choose_segments(OPT_NSTEPS,
                               target_len=max(256, int(OPT_NSTEPS ** 0.5)))
    check(OPT_NSTEPS // n_seg == PREFIX_L, f"prefix segment length "
                                           f"{OPT_NSTEPS // n_seg}")
    # per evaluation: R(t_left) (sign +1) and M(t_right) (sign -1) of every
    # segment in the forward, M(t_right) again in the backward with the
    # pair (R, L) at t_left
    per_eval = {"hermite_lhs_matrix": 3 * n_seg, "hermite_rhs": 0,
                "hermite_stage_pair": n_seg}
    per_eval_sign = {"-1": 2 * n_seg, "+1": n_seg}
    secs = []
    for _ in range(2):
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        (j1, g, r), grad = qt.prefix_objective_and_gradient(
            prob, controls, pcof0, tgt, ORDER, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = sk.launch_counts()
        by_sign = sk.lhs_launches_by_sign()
        check(counts == per_eval and by_sign == per_eval_sign,
              f"prefix launch counts {counts}, LHS by sign {by_sign} != "
              f"{per_eval}, {per_eval_sign}")
    obj = float(j1 + g + r)
    d_obj, d_grad = abs(obj - start["obj"]), _grad_rel(grad, start["grad"])
    d_obj64 = abs(obj - start["obj64"])
    d_grad64 = _grad_rel(grad, start["grad64"])
    prob64 = qt.cnot3_problem(nsteps=OPT_NSTEPS, device=dev)  # f64, "lu"
    (fj1, fg, fr), fgrad = qt.prefix_objective_and_gradient(
        prob64, controls, pcof0, tgt, ORDER, **kw)
    e_obj64 = abs(float(fj1 + fg + fr) - start["obj64"])
    e_grad64 = _grad_rel(fgrad, start["grad64"])
    phase("prefix", f"CNOT3 nsteps={OPT_NSTEPS}, 180 carrier parameters, "
                    f"{n_seg} segments of {PREFIX_L}, start point: f64 "
                    f"prefix vs f64 lu route |d obj| {e_obj64:.3e}, |d "
                    f"grad|/|grad| {e_grad64:.3e} (<= {PREFIX_F64_TOL:g}); "
                    f"f32 kernel route: objective {obj:.9f}, vs the f64 lu "
                    f"route {d_obj64:.3e} (<= {F64_OBJ_TOL:g}), "
                    f"{d_grad64:.3e} (<= {F64_GRAD_TOL:g}), vs the plain "
                    f"f32 kernel route {d_obj:.3e}, {d_grad:.3e} (reported; "
                    f"the plain route vs f64: "
                    f"{abs(start['obj'] - start['obj64']):.3e}, "
                    f"{_grad_rel(start['grad'], start['grad64']):.3e}); "
                    f"seconds per evaluation {[round(t, 3) for t in secs]} "
                    f"(plain route median "
                    f"{float(np.median(start['secs'])):.3f}); launches per "
                    f"evaluation {counts}, LHS by sign {by_sign}; {smi}")
    check(e_obj64 <= PREFIX_F64_TOL and e_grad64 <= PREFIX_F64_TOL,
          "f64 prefix vs f64 lu route")
    check(d_obj64 <= F64_OBJ_TOL and d_grad64 <= F64_GRAD_TOL,
          "f32 prefix vs f64 lu route")

    sk.reset_launch_counts()
    hist = qt.optimize_gate(prob, controls, pcof0, tgt, order=ORDER,
                            pcof_L=-OPT_BOUND, pcof_U=OPT_BOUND,
                            maxIter=OPT_ITERS, gradient_route="prefix",
                            print_level=0, **kw)
    torch.cuda.synchronize()
    counts = sk.launch_counts()
    by_sign = sk.lhs_launches_by_sign()
    n_eval = len(hist.obj_value)
    expected = {k: v * n_eval for k, v in per_eval.items()}
    expected_sign = {k: v * n_eval for k, v in per_eval_sign.items()}
    check(counts == expected and by_sign == expected_sign,
          f"prefix optimize launch counts {counts}, LHS by sign {by_sign} "
          f"!= {expected}, {expected_sign}")
    for row in rows:
        if row["phase"] == "prefix":
            row["launches"] = (
                counts["hermite_stage_pair"]
                if row["name"].startswith("hermite_stage_pair")
                else by_sign[f"{row['shape']['sign']:+d}"])
            row["launches_per_evaluation"] = row["launches"] // n_eval
    ev_secs = np.diff([0.0] + hist.wall_time)
    phase("prefix", f"optimize_gate(gradient_route='prefix'), L-BFGS-B "
                    f"maxIter={OPT_ITERS}, bounds +-{OPT_BOUND}: {n_eval} "
                    f"evaluations, objective per evaluation "
                    f"{[round(v, 9) for v in hist.obj_value]}, seconds per "
                    f"evaluation {[round(float(t), 3) for t in ev_secs]} "
                    f"(median {float(np.median(ev_secs)):.3f} s); launches "
                    f"{counts}, LHS by sign {by_sign}; {smi}")
    check(n_eval > 1 and min(hist.obj_value[1:]) < hist.obj_value[0],
          "prefix: a later objective below the first")
    check(all(np.isfinite(hist.obj_value)), "prefix: finite objectives")


def lbfgs_phase(dev, smi):
    """optimize_gate(method="lbfgs"): L-BFGS on the device with the zoom
    line search and projected bounds, LBFGS_ITERS iterations on the
    optimize phase's setup, prefix route."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    prob, controls, pcof0, tgt = _optimize_setup(dev)
    n_seg = OPT_NSTEPS // PREFIX_L
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    hist = qt.optimize_gate(prob, controls, pcof0, tgt, order=ORDER,
                            pcof_L=-OPT_BOUND, pcof_U=OPT_BOUND,
                            maxIter=LBFGS_ITERS, method="lbfgs",
                            gradient_route="prefix", print_level=0,
                            ridge_penalty_strength=1e-2)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    calls = sk.launch_counts()["hermite_lhs_matrix"] / (3 * n_seg)
    worst = float(np.abs(np.asarray(hist.pcof)).max())
    phase("lbfgs", f"optimize_gate(method='lbfgs', gradient_route='prefix'),"
                   f" {LBFGS_ITERS} iterations, bounds +-{OPT_BOUND}: "
                   f"objective per iteration "
                   f"{[round(v, 9) for v in hist.obj_value]}, {sec:.3f} s, "
                   f"{calls:g} objective+gradient calls (iterations and "
                   f"line-search probes), max |pcof| {worst:.6f}; {smi}")
    check(len(hist.obj_value) == LBFGS_ITERS, "lbfgs: one record per "
                                              "iteration")
    check(all(np.isfinite(hist.obj_value)), "lbfgs: finite objectives")
    check(min(hist.obj_value[1:]) < hist.obj_value[0],
          "lbfgs: a later objective below the first")
    check(worst <= OPT_BOUND, "lbfgs: the bounds hold")


def _graph_nodes(fn):
    """Nodes of a CUDA graph of one ``fn()`` call, as ``cuGraphGetNodes``
    counts them on a graph kept after its capture; ``None`` where this
    torch cannot keep one. The capture's launch counts are the
    caller's to discard."""
    import ctypes

    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    check(err == 0, f"cuGraphGetNodes: CUDA error {err}")
    return int(count.value)


def _chunk_walls(walls):
    """Seconds per forward and per backward chunk, from ``progress``."""
    return {ph: [round(w, 4) for p, w in walls if p == ph]
            for ph in ("fwd", "bwd")}


def chunked_phase(rows, start, dev, smi):
    """The host-chunked route (qgd_tpu_torch.chunked), its segment programs
    replayed as CUDA graphs: (a) the optimize phase's setup against the
    segmented route at the same segment count (one call, which captures
    its own programs) and float64 LU, with
    seconds per evaluation, capture seconds, graph nodes, device waits,
    peak memory and launches per evaluation; (b) float64 LU, chunked
    against segmented; (c) the long horizon; (d) optimize_gate(
    max_dispatch_steps=...) and a resume from its files alone."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch import chunked, segmented
    from qgd_tpu_torch.ops import stage_kernels as sk

    m = ORDER // 2
    prob, controls, pcof0, tgt = _optimize_setup(dev)
    L = OPT_NSTEPS // CHUNK_SEGMENTS
    kw = dict(ridge_penalty_strength=1e-2, n_segments=CHUNK_SEGMENTS)
    per_eval = {"hermite_lhs_matrix": 2 * CHUNK_SEGMENTS,
                "hermite_rhs": 2 * OPT_NSTEPS,
                "hermite_stage_pair": CHUNK_SEGMENTS}
    graphs, walls = chunked.SegmentGraphs(), []

    def run():
        del walls[:]
        return qt.chunked_objective_and_gradient(
            prob, controls, pcof0, tgt, ORDER, max_dispatch_steps=CHUNK_CAP,
            graphs=graphs, progress=lambda ph, k, n, w: walls.append((ph, w)),
            **kw)

    # evaluation 0 captures the programs, 1 runs under CUDA's sync debug
    # mode (device waits), 2 and 3 are timed. Memory: the peak of allocated
    # tensors above what was allocated when the evaluation started (a
    # replay allocates nothing: the graphs' memory is in their private
    # pools, which the growth of reserved memory over the four shows)
    secs, peaks = [], []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    for i in range(4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        if i == 1:
            ((j1, g, r), grad), waits = _device_waits(run)
        else:
            (j1, g, r), grad = run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        counts = sk.launch_counts()
        check(counts == per_eval, f"chunked launch counts, evaluation {i}: "
                                  f"{counts} != {per_eval}")
        if i == 0:
            first = graphs.stats()
    grown = torch.cuda.memory_reserved() - reserved0
    n_chunks = sum(ph == "fwd" for ph, _ in walls)
    stats = graphs.stats()
    check(stats["graphs"] == 2 and stats["replays"] == {
        "fwd": 4 * CHUNK_SEGMENTS - 1, "bwd": 4 * CHUNK_SEGMENTS - 1},
        f"chunked: two graphs, replayed for every segment but the first: "
        f"{stats}")
    _set_launches(rows, "chunked", counts)
    for row in rows:
        if row["phase"] == "chunked":
            row["launches_per_evaluation"] = row["launches"]
    nodes = _program_nodes(graphs, segmented._SegmentPrograms, prob, m, L,
                           1)
    nodes = {"fwd": nodes["forward"], "bwd": nodes["backward"]}
    sk.reset_launch_counts()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    (sj1, sg, sr), sgrad = qt.segmented_objective_and_gradient(
        prob, controls, pcof0, tgt, ORDER, **kw)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    seg_peak = torch.cuda.max_memory_allocated() - base
    seg_counts = sk.launch_counts()
    check(seg_counts == per_eval, f"segmented launch counts {seg_counts}")
    obj, sobj = float(j1 + g + r), float(sj1 + sg + sr)
    sgrad = sgrad.cpu()
    check(np.isfinite(obj) and bool(torch.isfinite(grad).all()),
          "chunked: finite objective and gradient")
    d_obj, d_grad = abs(obj - sobj) / abs(sobj), _grad_rel(grad, sgrad)
    bitwise = obj == sobj and bool(torch.equal(grad, sgrad))
    if start is None:
        prob64 = qt.cnot3_problem(nsteps=OPT_NSTEPS, device=dev)  # f64 lu
        (fj1, fg, fr), fgrad = qt.objective_and_gradient(
            prob64, controls, pcof0, tgt, ORDER, ridge_penalty_strength=1e-2)
        start = dict(obj64=float(fj1 + fg + fr), grad64=fgrad)
    grad64 = start["grad64"].cpu()
    d64 = {name: (abs(o - start["obj64"]), _grad_rel(gr, grad64))
           for name, o, gr in (("chunked", obj, grad),
                               ("segmented", sobj, sgrad))}
    steady = float(np.mean(secs[2:]))
    phase("chunked", f"(a) CNOT3 nsteps={OPT_NSTEPS}, 180 carrier "
                     f"parameters, start point, {CHUNK_SEGMENTS} segments of "
                     f"{L}, max_dispatch_steps={CHUNK_CAP}: {n_chunks} chunks;"
                     f" objective {obj:.9f}; chunked (graphs) vs "
                     f"segmented |d obj|/|obj| {d_obj:.3e} (<= "
                     f"{CHUNK_OBJ_TOL:g}), |d grad|/|grad| {d_grad:.3e} (<= "
                     f"{CHUNK_GRAD_TOL:g}), bit-identical {bitwise}; vs f64 "
                     f"lu (|d obj|, |d grad|/|grad|, <= {F64_OBJ_TOL:g}, "
                     f"{F64_GRAD_TOL:g}): chunked {d64['chunked'][0]:.3e}, "
                     f"{d64['chunked'][1]:.3e}, segmented "
                     f"{d64['segmented'][0]:.3e}, {d64['segmented'][1]:.3e}; "
                     f"{smi}")
    phase("chunked", f"(a) seconds per evaluation: chunked first (captures) "
                     f"{secs[0]:.3f}, under sync debug mode {secs[1]:.3f}, "
                     f"then {secs[2]:.3f}, {secs[3]:.3f} (mean {steady:.3f},"
                     f" {steady / (2 * OPT_NSTEPS) * 1e6:.2f} us per step and"
                     f" pass); segmented, one call that captures its "
                     f"own programs, {seg_s:.3f} "
                     f"({seg_s / (2 * OPT_NSTEPS) * 1e6:.2f} us per step and "
                     f"pass; {seg_s / steady:.2f} x the chunked route); "
                     f"capture {first['capture_seconds']:.3f} s for "
                     f"{first['graphs']} graphs of {nodes['fwd']} (fwd) and "
                     f"{nodes['bwd']} (bwd) nodes; device waits per "
                     f"evaluation {waits} ({n_chunks} forward chunks, "
                     f"{n_chunks} backward, 1 terminal); seconds per chunk, "
                     f"last evaluation {_chunk_walls(walls)}; peak memory "
                     f"above the evaluation's start: chunked "
                     f"{[round(p / 1e9, 4) for p in peaks]} GB (reserved "
                     f"memory grew {grown / 1e9:.4f} GB over the four), "
                     f"segmented {seg_peak / 1e9:.4f} GB; launches per "
                     f"evaluation {counts} (replays x launches per capture), "
                     f"graph replays over the 4 evaluations "
                     f"{stats['replays']}; {smi}")
    check(d_obj <= CHUNK_OBJ_TOL and d_grad <= CHUNK_GRAD_TOL,
          "chunked vs segmented")
    for name, (e_obj, e_grad) in d64.items():
        check(e_obj <= F64_OBJ_TOL and e_grad <= F64_GRAD_TOL,
              f"{name} vs f64 lu")

    # (b) float64 LU on the card: the graphs hold the cuSOLVER LU
    prob_s = qt.cnot3_problem(tf=CHUNK_F64_NSTEPS * 0.1,
                              nsteps=CHUNK_F64_NSTEPS, device=dev)
    controls_s = [qt.CarrierControl(qt.BSpline2Control(10, prob_s.tf), f)
                  for f in qt.cnot3_carrier_frequencies()]
    kw_s = dict(ridge_penalty_strength=1e-2, n_segments=CHUNK_F64_SEGMENTS)
    graphs_s = chunked.SegmentGraphs()
    t0 = time.perf_counter()
    (cj1, cg, cr), cgrad = qt.chunked_objective_and_gradient(
        prob_s, controls_s, pcof0, tgt, ORDER,
        max_dispatch_steps=CHUNK_F64_CAP, graphs=graphs_s, **kw_s)
    c_s = time.perf_counter() - t0
    (sj1, sg, sr), sgrad = qt.segmented_objective_and_gradient(
        prob_s, controls_s, pcof0, tgt, ORDER, **kw_s)
    cobj, sobj = float(cj1 + cg + cr), float(sj1 + sg + sr)
    sgrad = sgrad.cpu()
    e_obj, e_grad = abs(cobj - sobj) / abs(sobj), _grad_rel(cgrad, sgrad)
    phase("chunked", f"(b) f64 lu, CNOT3 nsteps={CHUNK_F64_NSTEPS} (tf "
                     f"{prob_s.tf:g}), {CHUNK_F64_SEGMENTS} segments, "
                     f"max_dispatch_steps={CHUNK_F64_CAP}: chunked vs "
                     f"segmented |d obj|/|obj| {e_obj:.3e}, |d grad|/|grad| "
                     f"{e_grad:.3e} (<= {CHUNK_F64_TOL:g}), bit-identical "
                     f"{cobj == sobj and bool(torch.equal(cgrad, sgrad))}; "
                     f"graphs {graphs_s.stats()}; first call {c_s:.3f} s; "
                     f"{smi}")
    check(graphs_s.stats()["graphs"] == 2, "f64 lu: both programs captured")
    check(e_obj <= CHUNK_F64_TOL and e_grad <= CHUNK_F64_TOL,
          "f64 chunked vs segmented")

    # (c) the long horizon, one evaluation (it captures its programs)
    prob_l, controls_l = _long_problem(dev)
    S_l = qt.choose_segments(LONG_NSTEPS)
    L_l = LONG_NSTEPS // S_l

    def long_run(p, cap):
        walls_l = []
        graphs_l = chunked.SegmentGraphs()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        (lj1, lg, lr), lgrad = qt.chunked_objective_and_gradient(
            p, controls_l, pcof0, tgt, ORDER, ridge_penalty_strength=1e-2,
            max_dispatch_steps=cap, graphs=graphs_l,
            progress=lambda ph, k, n, w: walls_l.append((ph, w)))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        check(np.isfinite(float(lj1 + lg + lr)) and
              bool(torch.isfinite(lgrad).all()),
              f"long horizon {p.nsteps}: finite objective and gradient")
        return (float(lj1 + lg + lr), sec, walls_l, graphs_l.stats(),
                torch.cuda.max_memory_allocated() - base, sk.launch_counts())

    obj_l, sec_l, walls_l, st_l, peak_l, counts_l = long_run(prob_l,
                                                             LONG_CAP)
    check(counts_l == {"hermite_lhs_matrix": 2 * S_l,
                       "hermite_rhs": 2 * LONG_NSTEPS,
                       "hermite_stage_pair": S_l},
          f"long horizon launch counts {counts_l}")
    _set_launches(rows, "chunked_long", counts_l)
    for row in rows:
        if row["phase"] == "chunked_long":
            row["launches_per_evaluation"] = row["launches"]
    run_s = sec_l - st_l["capture_seconds"]
    res = qt.stage_residuals(prob_l, controls_l, pcof0, ORDER, sample=8)
    phase("chunked", f"(c) CNOT3 nsteps={LONG_NSTEPS} (dt "
                     f"{prob_l.tf / LONG_NSTEPS:g}), f32, one control vector,"
                     f" {S_l} segments of {L_l}, max_dispatch_steps="
                     f"{LONG_CAP}: objective {obj_l:.9f}, {sec_l:.3f} s for "
                     f"one objective + gradient ({st_l['capture_seconds']:.3f}"
                     f" s of it capture), seconds per chunk "
                     f"{_chunk_walls(walls_l)}; peak memory above its start "
                     f"{peak_l / 1e9:.4f} GB; launches {counts_l}; stage "
                     f"residual, 8 probes: max {res['max']:.3e} mean "
                     f"{res['mean']:.3e} (limit {MILESTONE_RESIDUAL:g}); "
                     f"projection (not a measurement) at the reference's "
                     f"5.5e6 steps: {run_s * 5.5e6 / LONG_NSTEPS / 60:.1f} "
                     f"min per objective + gradient; {smi}")
    check(res["max"] <= MILESTONE_RESIDUAL, "long horizon: stage residual")
    if run_s * 10 <= LONG_BUDGET_S:
        prob_x = dataclasses.replace(prob_l, nsteps=10 * LONG_NSTEPS)
        obj_x, sec_x, walls_x, st_x, peak_x, counts_x = long_run(
            prob_x, 10 * LONG_CAP)
        phase("chunked", f"(c) CNOT3 nsteps={prob_x.nsteps} (dt "
                         f"{prob_x.tf / prob_x.nsteps:g}): objective "
                         f"{obj_x:.9f}, {sec_x:.3f} s "
                         f"({st_x['capture_seconds']:.3f} s capture), "
                         f"{sum(ph == 'fwd' for ph, _ in walls_x)} chunks, "
                         f"peak memory above its start {peak_x / 1e9:.4f} "
                         f"GB; launches "
                         f"{counts_x}; {smi}")
    else:
        phase("chunked", f"(c) {10 * LONG_NSTEPS} steps not run: "
                         f"{LONG_NSTEPS} took {run_s:.1f} s past capture, "
                         f"ten times that exceeds {LONG_BUDGET_S:g} s")

    # (d) the optimizer's chunked route, saved and resumed from its files
    route, calls = chunked.chunked_objective_and_gradient, []

    def spy(*args, **kwargs):
        calls.append(kwargs["max_dispatch_steps"])
        return route(*args, **kwargs)

    chunked.chunked_objective_and_gradient = spy
    try:
        with tempfile.TemporaryDirectory() as tmp:
            base = os.path.join(tmp, "cnot3_chunked")
            sk.reset_launch_counts()
            hist = qt.optimize_gate(
                prob, controls, pcof0, tgt, order=ORDER, pcof_L=-OPT_BOUND,
                pcof_U=OPT_BOUND, maxIter=OPT_CHUNK_ITERS, print_level=0,
                filename=base, max_dispatch_steps=CHUNK_CAP, **kw)
            torch.cuda.synchronize()
            counts = sk.launch_counts()
            n_eval = len(hist.obj_value)
            check(calls == [CHUNK_CAP] * n_eval, f"optimize_gate took the "
                                                 f"chunked route: {calls}")
            check(counts == {k: v * n_eval for k, v in per_eval.items()},
                  f"chunked optimize launch counts {counts}")
            check(n_eval > 1 and min(hist.obj_value[1:]) < hist.obj_value[0],
                  "chunked optimize: a later objective below the first")
            del calls[:]
            resumed = qt.resume_optimization(base, device=dev, maxIter=1,
                                             print_level=0)
            torch.cuda.synchronize()
            more = len(resumed.obj_value) - n_eval
            check(more > 0 and calls == [CHUNK_CAP] * more,
                  f"the resumed run took the chunked route: {calls}")
    finally:
        chunked.chunked_objective_and_gradient = route
    ev_secs = np.diff([0.0] + hist.wall_time)
    phase("chunked", f"(d) optimize_gate(max_dispatch_steps={CHUNK_CAP}, "
                     f"n_segments={CHUNK_SEGMENTS}), L-BFGS-B maxIter="
                     f"{OPT_CHUNK_ITERS}: {n_eval} evaluations, objectives "
                     f"{[round(v, 9) for v in hist.obj_value]}, seconds per "
                     f"evaluation {[round(float(t), 3) for t in ev_secs]}; "
                     f"launches {counts}; resume_optimization from the files"
                     f" alone: {more} more on the chunked route, last "
                     f"objective {resumed.obj_value[-1]:.9f}; {smi}")


def forced_phase(dev, smi):
    """The VERDICT gate in float64 on the card: the general-L segmented
    gradient of Rabi at nsteps = FORCED_NSTEPS (automatic segments) against
    forward-mode AD; then forward mode through the f32 kernels."""
    import qgd_tpu_torch as qt

    prob = qt.construct_rabi_prob(nsteps=FORCED_NSTEPS, device=dev)
    controls = (qt.BSpline2Control(4, prob.tf),)
    rng = np.random.default_rng(3)
    pcof = rng.standard_normal(8) * 0.3
    tgt = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    n_seg = qt.choose_segments(FORCED_NSTEPS)
    t0 = time.perf_counter()
    (_, _, _), g_seg = qt.segmented_objective_and_gradient(prob, controls,
                                                           pcof, tgt, ORDER)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g_for = qt.eval_grad_forced(prob, controls, pcof, tgt, ORDER)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    scale = max(1.0, float(g_for.abs().max()))
    excess = float(((g_seg - g_for).abs()
                    - (FORCED_ATOL * scale + FORCED_RTOL * g_for.abs())).max())
    rel = float((g_seg - g_for).abs().max()) / scale
    phase("forced", f"Rabi nsteps={FORCED_NSTEPS}, BSpline2Control(4), f64 "
                    f"on the card: segmented gradient ({n_seg} segments of "
                    f"{FORCED_NSTEPS // n_seg}, {t1 - t0:.3f} s) vs "
                    f"eval_grad_forced ({t2 - t1:.3f} s): max |d g| / "
                    f"max(1, |g|max) {rel:.3e} (gate rtol {FORCED_RTOL:g}, "
                    f"atol {FORCED_ATOL:g} x scale); {smi}")
    check(excess <= 0.0, "forced: segmented vs forced gradient")
    _forced_f32(dev, smi)


def _forced_f32(dev, smi):
    """Forward mode through the f32 kernels on the card: the forced
    gradient of CNOT3 at FORCED32_NSTEPS against float64 and against the
    f32 kernel route's Lagrange gradient, and the AD Hessian of the small
    CNOT3 problem against float64, with the launches each call made."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk

    def problems(**kw):
        return [qt.cnot3_problem(solver="schulz", schulz_iters=48,
                                 schulz_warm_budget=0, dtype=d, device=dev,
                                 **kw)
                for d in ("float32", "float64")]

    def counted(fn, *args):
        sk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, sk.launch_counts()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    prob32, prob64 = problems(nsteps=FORCED32_NSTEPS, tf=FORCED32_TF)
    controls = tuple(qt.BSpline2Control(10, prob32.tf) for _ in range(3))
    pcof = np.random.default_rng(0).standard_normal(60) * 0.01
    tgt = qt.cnot3_target(tf=FORCED32_TF)
    g32, sec, counts = counted(qt.eval_grad_forced, prob32, controls, pcof,
                               tgt, ORDER)
    g64 = qt.eval_grad_forced(prob64, controls, pcof, tgt, ORDER)
    _, g_lag = qt.objective_and_gradient(prob32, controls, pcof, tgt, ORDER)
    d64, d_lag = rel(g32, g64), rel(g32, g_lag)
    phase("forced", f"eval_grad_forced in f32 on the card: CNOT3 nsteps="
                    f"{FORCED32_NSTEPS} tf={FORCED32_TF:g}, 3 x "
                    f"BSpline2Control(10) (60 parameters), schulz warm 0: "
                    f"{sec:.3f} s; launches during the call {counts}; "
                    f"|d g|/|g| vs the f64 forced gradient {d64:.3e} (<= "
                    f"{F64_GRAD_TOL:g}), vs the f32 kernel route's Lagrange "
                    f"gradient {d_lag:.3e} (<= {ROUTE_GRAD_TOL:g}); {smi}")
    check(bool(torch.isfinite(g32).all()) and g32.shape == (60,),
          "forced f32: finite gradient of the expected shape")
    check(counts["hermite_lhs_matrix"] > 0 and counts["hermite_rhs"] > 0,
          f"forced f32: the tangents passed the LHS and RHS kernels "
          f"{counts}")
    check(d64 <= F64_GRAD_TOL, "forced f32 vs forced f64")
    check(d_lag <= ROUTE_GRAD_TOL, "forced f32 vs f32 Lagrange gradient")

    prob32, prob64 = problems(nsteps=4, tf=2.2)
    controls = tuple(qt.BSpline2Control(4, prob32.tf) for _ in range(3))
    pcof = np.random.default_rng(1).standard_normal(24) * 0.05
    tgt = qt.cnot3_target(tf=2.2)
    H32, sec, counts = counted(qt.eval_hessian, prob32, controls, pcof, tgt,
                               ORDER)
    H64 = qt.eval_hessian(prob64, controls, pcof, tgt, ORDER)
    d64, asym = rel(H32, H64), rel(H32, H32.T)
    phase("forced", f"eval_hessian(method='ad') in f32 on the card: CNOT3 "
                    f"nsteps=4 tf=2.2, 3 x BSpline2Control(4) (24 "
                    f"parameters): {sec:.3f} s; launches during the call "
                    f"{counts}; |d H|_F/|H|_F vs the f64 AD Hessian "
                    f"{d64:.3e}, |H - H^T|_F/|H|_F {asym:.3e} (each <= "
                    f"{F64_GRAD_TOL:g}); {smi}")
    check(all(n > 0 for n in counts.values()),
          f"hessian f32: the tangents passed every kernel {counts}")
    check(d64 <= F64_GRAD_TOL and asym <= F64_GRAD_TOL,
          "hessian f32 vs f64, and symmetric")


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


def gmres_phase(pcof, tgt, rows, start, dev, smi):
    """The matrix-free route (``solver="gmres"``, diagonal preconditioner,
    GMRES_ITERS Arnoldi steps): (a) the main path's configuration on the
    segmented route, held against float64 LU, with launches by sign, s/call,
    peak memory and stage residual; the autograd gradient of a short slice
    through the transposed solves; (b) optimize_gate on the optimize
    phase's setup. (c) is :func:`gmres_large_phase`."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk
    from qgd_tpu_torch.segmented import _segment_count

    t_phase = time.perf_counter()
    per_step = GMRES_ITERS + 1          # the initial residual and iters
    gkw = dict(solver="gmres", gmres_iters=GMRES_ITERS,
               preconditioner_type="diagonal", dtype="float32", device=dev)

    # (a) the main path's configuration
    prob = qt.cnot3_problem(nsteps=NSTEPS, **gkw)
    controls = tuple(qt.BSpline2Control(10, prob.tf) for _ in range(3))
    n_auto = _segment_count(prob, 0, SCENARIOS)     # the automatic rule
    passes = 1 if n_auto == NSTEPS else 2       # L > 1 re-forwards
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        (j1, g, _), grad = qt.segmented_objective_and_gradient(
            prob, controls, pcof, tgt, ORDER)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        by_sign = sk.rhs_launches_by_sign()
        lhs_n = sk.launch_counts()["hermite_lhs_matrix"]
        pair_n = sk.launch_counts()["hermite_stage_pair"]
    peak = torch.cuda.max_memory_allocated()
    expected = {"-1": passes * NSTEPS * per_step, "+1": passes * NSTEPS}
    # the backward's pairs: one launch per step at L = 1, per segment else
    pair_expected = NSTEPS if passes == 1 else n_auto
    check(by_sign == expected and lhs_n == 0 and pair_n == pair_expected,
          f"gmres launches by sign {by_sign}, LHS {lhs_n}, pair {pair_n} != "
          f"{expected}, 0, {pair_expected}")
    for row in rows:
        if row["phase"] == "gmres":
            row["launches"] = by_sign["-1"]
            row["launches_per_call"] = by_sign["-1"]
    check(bool(torch.isfinite(j1 + g).all() and torch.isfinite(grad).all()),
          "gmres: finite objective and gradient")
    k = 4
    prob64 = qt.cnot3_problem(nsteps=NSTEPS, device=dev)    # f64, "lu"
    (fj1, fg, _), fgrad = qt.segmented_objective_and_gradient(
        prob64, controls, pcof[:k], tgt, ORDER)
    d_obj, d_grad = _scenario_deltas((j1 + g)[:k], grad[:k], fj1 + fg,
                                     fgrad)
    res = qt.stage_residuals(prob, controls, pcof[:1], ORDER, sample=8)
    phase("gmres", f"CNOT3 nsteps={NSTEPS} S={SCENARIOS} f32, GMRES("
                   f"{GMRES_ITERS}) diagonal preconditioner, automatic "
                   f"rule n_segments={n_auto}: seconds per call "
                   f"{[round(t, 3) for t in secs]}, peak memory "
                   f"{peak / 1e9:.3f} GB; RHS launches by sign {by_sign} "
                   f"(per forward step 1 explicit half and {per_step} "
                   f"operator applications), LHS launches {lhs_n}, "
                   f"pair launches {pair_n} (the backward's, programs run "
                   f"eagerly: GMRES is not captured); "
                   f"scenarios 0-3 vs the f64 lu route: |d obj| "
                   f"{d_obj:.3e} (<= {F64_OBJ_TOL:g}), |d grad|/|grad| "
                   f"{d_grad:.3e} (<= {F64_GRAD_TOL:g}); stage residual, "
                   f"scenario 0, 8 probes: max {res['max']:.3e} mean "
                   f"{res['mean']:.3e} (limit {MILESTONE_RESIDUAL:g}); {smi}")
    check(d_obj <= F64_OBJ_TOL and d_grad <= F64_GRAD_TOL,
          "gmres: f32 route vs f64 lu route")
    check(res["max"] <= MILESTONE_RESIDUAL, "gmres: stage residual")
    # host operations and device time of the GMRES forward step, profiled
    # over GMRES_TRACE_STEPS steps of the same configuration
    prob_t = qt.cnot3_problem(tf=prob.tf / NSTEPS * GMRES_TRACE_STEPS,
                              nsteps=GMRES_TRACE_STEPS, **gkw)
    top, nested, busy_ms, wall_ms = _profile_ops(
        lambda: qt.eval_forward(prob_t, controls, pcof, ORDER))
    per_trace = top / GMRES_TRACE_STEPS
    phase("gmres", f"eval_forward, {GMRES_TRACE_STEPS} steps at S="
                   f"{SCENARIOS}, torch.profiler on: {per_trace:.0f} "
                   f"host-level aten operations per step "
                   f"({nested / GMRES_TRACE_STEPS:.0f} with nested ones), "
                   f"{per_trace / per_step:.1f} per operator "
                   f"application; wall {wall_ms:.1f} ms, device kernels "
                   f"{busy_ms:.1f} ms (busy {busy_ms / wall_ms:.3f}); {smi}")

    # the autograd gradient of a GMRES_AD_STEPS slice: its backward solves
    # the transposed stages by GMRES on the transposed stacks
    prob_ad = qt.cnot3_problem(tf=prob.tf / NSTEPS * GMRES_AD_STEPS,
                               nsteps=GMRES_AD_STEPS, **gkw)
    pc = pcof.detach().clone().requires_grad_(True)
    sk.reset_launch_counts()
    with torch.enable_grad():
        val = qt.objective_value(prob_ad, controls, pc, tgt, ORDER)
        fwd = sk.rhs_launches_by_sign()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        (g_ad,) = torch.autograd.grad(val.sum(), pc)
        torch.cuda.synchronize()
        t_bwd = time.perf_counter() - t0
    bwd = sk.rhs_launches_by_sign()
    check(fwd == {"-1": GMRES_AD_STEPS * per_step, "+1": GMRES_AD_STEPS}
          and bwd == {"-1": GMRES_AD_STEPS * per_step, "+1": 0},
          f"gmres autograd launches forward {fwd}, backward {bwd}")
    for row in rows:
        if row["phase"] == "gmres_ad":
            row["launches"] = bwd["-1"]
            row["launches_per_call"] = bwd["-1"]
    _, g_la = qt.objective_and_gradient(prob_ad, controls, pcof, tgt, ORDER)
    d_ad = _scenario_deltas(val.detach(), g_ad, val.detach(), g_la)[1]
    phase("gmres", f"autograd gradient, CNOT3 nsteps={GMRES_AD_STEPS} "
                   f"S={SCENARIOS}: backward {t_bwd:.3f} s, transposed-stack "
                   f"operator launches {bwd['-1']}; vs the Lagrange route "
                   f"|d grad|/|grad| {d_ad:.3e} (<= {F64_GRAD_TOL:g}); {smi}")
    check(d_ad <= F64_GRAD_TOL, "gmres: autograd vs Lagrange gradient")
    del g_ad, val, pc

    # (b) optimize_gate on the optimize phase's setup
    prob_o, controls_o, pcof0, tgt_o = _optimize_setup(dev)
    prob_o = dataclasses.replace(prob_o, solver="gmres",
                                 gmres_iters=GMRES_OPT_BUDGET,
                                 preconditioner_type="diagonal")
    res_o = qt.stage_residuals(prob_o, controls_o, pcof0, ORDER, sample=8)
    check(res_o["max"] <= MILESTONE_RESIDUAL, "gmres optimize: stage residual")
    sk.reset_launch_counts()
    hist = qt.optimize_gate(prob_o, controls_o, pcof0, tgt_o, order=ORDER,
                            pcof_L=-OPT_BOUND, pcof_U=OPT_BOUND,
                            maxIter=GMRES_OPT_ITERS, print_level=0,
                            ridge_penalty_strength=1e-2)
    torch.cuda.synchronize()
    n_eval = len(hist.obj_value)
    by_sign = sk.rhs_launches_by_sign()
    expected = {"-1": n_eval * OPT_NSTEPS * (GMRES_OPT_BUDGET + 1),
                "+1": n_eval * OPT_NSTEPS}
    pair_n = sk.launch_counts()["hermite_stage_pair"]
    # the adjoint's pairs, one per interior step (GMRES hoists no stage)
    check(by_sign == expected and pair_n == n_eval * (OPT_NSTEPS - 1),
          f"gmres optimize launches {by_sign}, pair {pair_n} != {expected}, "
          f"{n_eval * (OPT_NSTEPS - 1)}")
    for row in rows:
        if row["phase"] == "gmres_optimize":
            n = (pair_n if row["name"].startswith("hermite_stage_pair")
                 else by_sign["-1"])
            row["launches"] = n
            row["launches_per_evaluation"] = n // n_eval
    ev = np.diff([0.0] + hist.wall_time)
    phase("gmres", f"optimize_gate, CNOT3 nsteps={OPT_NSTEPS}, 180 carrier "
                   f"parameters, f32 GMRES({GMRES_OPT_BUDGET}) diagonal "
                   f"(stage residual at the start, 8 probes: max "
                   f"{res_o['max']:.3e}), L-BFGS-B "
                   f"maxIter={GMRES_OPT_ITERS}: {n_eval} evaluations, "
                   f"objective per evaluation "
                   f"{[round(v, 9) for v in hist.obj_value]} (the Schulz "
                   f"route's start {start['obj']:.9f}), seconds per "
                   f"evaluation {[round(float(t), 3) for t in ev]} (median "
                   f"{float(np.median(ev)):.3f} s; the Schulz plain route's "
                   f"median {float(np.median(start['secs'])):.3f} s); RHS "
                   f"launches by sign {by_sign}; {smi}")
    check(n_eval > 1 and min(hist.obj_value[1:]) < hist.obj_value[0],
          "gmres optimize: a later objective below the first")
    check(abs(hist.obj_value[0] - start["obj"]) <= F64_OBJ_TOL,
          "gmres optimize: the start objective is the Schulz route's")
    phase("gmres", f"phase {time.perf_counter() - t_phase:.1f} s; {smi}")


def gmres_large_phase(pcof, rows, dev, smi):
    """(c) of the gmres phase: a 512-level system whose stage matrices are
    not built, single-device and level-sharded over a one-rank NCCL group,
    held against float64 LU."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk
    from qgd_tpu_torch.parallel import make_tp_mesh, tp_forward_history

    t_phase = time.perf_counter()
    per_step = GMRES_ITERS + 1          # the initial residual and iters
    prob_l, controls_l = _large_problem(dev)
    pc1 = pcof[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_fwd = []
    for _ in range(2):
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        h = qt.eval_forward(prob_l, controls_l, pc1, ORDER)
        torch.cuda.synchronize()
        t_fwd.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    by_sign = sk.rhs_launches_by_sign()
    check(by_sign == {"-1": LARGE_NSTEPS * per_step, "+1": LARGE_NSTEPS},
          f"large system launches {by_sign}")
    for row in rows:
        if row["phase"] == "gmres_large":
            row["launches"] = by_sign["-1"]
            row["launches_per_call"] = by_sign["-1"]
    prob_l64, _ = _large_problem(dev, dtype="float64", solver="lu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        h64 = qt.eval_forward(prob_l64, controls_l, pc1, ORDER)
        torch.cuda.synchronize()
        t64 = time.perf_counter() - t0
    capped = any("hoisted stage precompute disabled" in str(w.message)
                 for w in caught)
    d_large = float((h.double() - h64).abs().max())
    n2 = prob_l.real_system_size
    state = n2 * 8 * 4
    hoisted = 3 * OPT_NSTEPS * n2 * n2 * 4
    gmres_5500 = peak + (OPT_NSTEPS - LARGE_NSTEPS) * state
    port = _free_port()
    group = make_tp_mesh(1, device=dev, init_method=f"tcp://localhost:{port}",
                         rank=0)
    try:
        t0 = time.perf_counter()
        h_tp = tp_forward_history(prob_l, controls_l, pc1, group, ORDER)
        torch.cuda.synchronize()
        t_tp = time.perf_counter() - t0
    finally:
        torch.distributed.destroy_process_group()
    d_tp = float((h_tp - h).abs().max())
    phase("gmres", f"512 levels (2N = {n2}, 8 columns), nsteps="
                   f"{LARGE_NSTEPS}, dt=0.1, f32 GMRES({GMRES_ITERS}) "
                   f"diagonal, S=1: {', '.join(f'{t:.3f}' for t in t_fwd)}"
                   f" s per call, peak memory above the "
                   f"problem {peak / 1e6:.1f} MB (at {OPT_NSTEPS} steps "
                   f"{gmres_5500 / 1e9:.3f} GB with the longer history, where "
                   f"the hoisted LU route would hold {hoisted / 1e9:.1f} GB "
                   f"of f32 stage tensors); RHS-kernel operator launches "
                   f"{by_sign['-1']}, explicit halves {by_sign['+1']}; vs "
                   f"the f64 lu route ({t64:.3f} s, hoisting capped: "
                   f"{capped}) max |d w| {d_large:.3e} (<= "
                   f"{LARGE_F64_TOL:g}); level-sharded on a one-rank NCCL "
                   f"group {t_tp:.3f} s, vs single-device GMRES max |d w| "
                   f"{d_tp:.3e} (<= {TP_TOL:g}); {smi}")
    check(bool(torch.isfinite(h).all()) and h.shape == (LARGE_NSTEPS + 1,
                                                        n2, 8),
          "large system: finite history of the expected shape")
    check(d_large <= LARGE_F64_TOL, "large system: f32 GMRES vs f64 lu")
    check(d_tp <= TP_TOL, "large system: level-sharded vs single-device")
    phase("gmres", f"(c) {time.perf_counter() - t_phase:.1f} s; {smi}")


def sharded_phase(prob, controls, pcof, tgt, dev, rows, smi):
    """parallel.sharded at the main path's width: (a) the batched call on
    a 1 x 1 mesh of one NCCL rank against the unsharded segmented call,
    (c) TRAIN_STEPS training steps on that mesh, (b) the gate columns
    split over two processes on the one card (:func:`_split_worker`)
    against one process."""
    import torch.distributed as dist

    import qgd_tpu_torch as qt
    from qgd_tpu_torch.ops import stage_kernels as sk
    from qgd_tpu_torch.parallel import (batched_objective_and_grad,
                                        initialize_distributed, make_mesh,
                                        multichip_train_step)

    initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cuda")
    try:
        check(dist.get_backend() == "nccl", "sharded: one NCCL rank")
        mesh = make_mesh(1, 1)
        call = lambda: batched_objective_and_grad(
            prob, controls, pcof, tgt, mesh, ORDER,
            gradient_method="segmented")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        (vals, grads), waits = _device_waits(call)
        torch.cuda.synchronize()
        secs = [time.perf_counter() - t0]
        counts = sk.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        expected = {"hermite_lhs_matrix": NSTEPS, "hermite_rhs": NSTEPS,
                    "hermite_stage_pair": NSTEPS}
        check(counts == expected, f"sharded (a) launches {counts} != "
                                  f"{expected}")
        check(vals.shape == (SCENARIOS,) and grads.shape == (SCENARIOS, 60)
              and bool(torch.isfinite(vals).all()
                       and torch.isfinite(grads).all()),
              "sharded (a): finite values of the expected shapes")
        (j1, g, _), grad = qt.segmented_objective_and_gradient(
            prob, controls, pcof, tgt, ORDER)
        d_obj, d_grad = _scenario_deltas(vals, grads, j1 + g, grad)
        phase("sharded", f"(a) batched_objective_and_grad, 1 x 1 mesh of "
                         f"one NCCL rank, CNOT3 nsteps={NSTEPS} S="
                         f"{SCENARIOS} f32 segmented route vs the unsharded "
                         f"call: |d obj| {d_obj:.3e} (<= {SHARD_OBJ_TOL:g}),"
                         f" |d grad|/|grad| {d_grad:.3e} (<= "
                         f"{SHARD_GRAD_TOL:g}); seconds per call "
                         f"{[round(t, 3) for t in secs]} (the first under "
                         f"sync debug mode), device waits per call {waits},"
                         f" peak memory {peak / 1e9:.3f} GB, launches per "
                         f"call {counts}; {smi}")
        check(d_obj <= SHARD_OBJ_TOL and d_grad <= SHARD_GRAD_TOL,
              "sharded (a): one NCCL rank vs unsharded")

        step = multichip_train_step(prob, controls, tgt, mesh, ORDER,
                                    learning_rate=TRAIN_LR,
                                    gradient_method="segmented")
        p, means = pcof, []
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            p, v = step(p)
            means.append(float(v.mean()))
        sec = (time.perf_counter() - t0) / TRAIN_STEPS
        phase("sharded", f"(c) multichip_train_step, S={SCENARIOS}, "
                         f"learning rate {TRAIN_LR:g}, ridge 1e-2: mean "
                         f"objective per step {[round(m, 9) for m in means]}"
                         f", {sec:.3f} s per step; {smi}")
        check(all(b < a for a, b in zip(means, means[1:])),
              "sharded (c): the mean objective falls")
    finally:
        dist.destroy_process_group()

    # (b) two processes on the one card, 4 gate columns each
    with tempfile.TemporaryDirectory() as tmp:
        port = str(_free_port())
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in (0, 1)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--split-worker", str(r), port, outs[r]],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in (0, 1)]
        try:
            logs = [pr.communicate(timeout=SPLIT_TIMEOUT_S)[0]
                    for pr in procs]
        finally:
            for pr in procs:
                pr.kill()
        wall = time.perf_counter() - t0
        for r, (pr, log) in enumerate(zip(procs, logs)):
            check(pr.returncode == 0, f"sharded (b): rank {r} exited "
                                      f"{pr.returncode}:\n{log[-3000:]}")
        got = [dict(np.load(o)) for o in outs]
    (j1, g, _), grad = qt.objective_and_gradient(prob, controls, pcof[0],
                                                 tgt, ORDER)
    obj = float(j1 + g)
    d_obj = max(abs(float(r["val"]) - obj) / abs(obj) for r in got)
    d_grad = max(float(np.linalg.norm(r["grad"] - grad.cpu().numpy())
                       / float(grad.norm())) for r in got)
    counts = json.loads(str(got[0]["counts"]))
    expected = {"hermite_lhs_matrix": 1, "hermite_rhs": NSTEPS,
                "hermite_stage_pair": 1}
    check(all(json.loads(str(r["counts"])) == expected for r in got),
          f"sharded (b) launches {[str(r['counts']) for r in got]} != "
          f"{expected}")
    _set_launches(rows, "sharded", counts)
    phase("sharded", f"(b) sharded_objective_and_grad, 1 x 2 mesh, two "
                     f"processes on the one card ({got[0]['backend']}, "
                     f"CUDA tensors), 4 of the 8 gate columns each, one "
                     f"control vector, plain route (auto at {NSTEPS} "
                     f"steps): vs one process |d obj|/|obj| {d_obj:.3e}, "
                     f"|d grad|/|grad| {d_grad:.3e} (<= {SPLIT_REL_TOL:g}); "
                     f"seconds per call rank 0 "
                     f"{[round(float(t), 3) for t in got[0]['secs']]}, rank "
                     f"1 {[round(float(t), 3) for t in got[1]['secs']]} (the"
                     f" first under sync debug mode); device waits per call "
                     f"{[int(r['waits']) for r in got]}; peak memory per "
                     f"process {[round(float(r['peak']) / 1e9, 3) for r in got]}"
                     f" GB; launches per call and rank {counts}; both "
                     f"processes {wall:.1f} s from start to exit; {smi}")
    check(d_obj <= SPLIT_REL_TOL and d_grad <= SPLIT_REL_TOL,
          "sharded (b): two processes vs one")


def _split_worker(rank, port, out):
    """One of the two processes of the sharded phase's (b): the main
    path's problem with 4 of its 8 gate columns on a 1 x 2 mesh over
    gloo, scenario 0's objective and gradient with the launches of one
    call, its seconds per call, device waits and peak memory, saved to
    ``out``."""
    import torch.distributed as dist

    from qgd_tpu_torch.ops import stage_kernels as sk
    from qgd_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                        sharded_objective_and_grad)

    initialize_distributed(f"localhost:{port}", 2, rank, device="cuda",
                           backend=SPLIT_BACKEND)
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        prob, controls, pcof, tgt = _main_setup(dev)
        mesh = make_mesh(1, 2)
        call = lambda: sharded_objective_and_grad(prob, controls, pcof[0],
                                                  tgt, mesh, ORDER)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        (val, grad), waits = _device_waits(call)
        torch.cuda.synchronize()
        secs = [time.perf_counter() - t0]
        counts = sk.launch_counts()
        for _ in range(2):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        np.savez(out, val=float(val), grad=grad.cpu().numpy(),
                 counts=json.dumps(counts), secs=np.array(secs), waits=waits,
                 peak=torch.cuda.max_memory_allocated(),
                 backend=dist.get_backend())
    finally:
        dist.destroy_process_group()


def utils_phase(prob, pcof, dev, smi):
    """The utilities on the card: the Richardson harness on Rabi, the
    Stormer-Verlet baseline on CNOT3 carried through the Juqbox fields
    against the Hermite forward, and the step estimate of CNOT3."""
    import qgd_tpu_torch as qt

    t0 = time.perf_counter()
    rabi = qt.construct_rabi_prob(tf=2 * np.pi, nsteps=RICH_BASE, device=dev)
    pc = np.random.default_rng(2).standard_normal(2) * 0.5 + 0.3
    res = qt.get_histories(rabi, qt.GRAPEControl(1, rabi.tf), pc,
                           RICH_REFINE, orders=RICH_ORDERS, verbose=False)
    slopes = {}
    for order in RICH_ORDERS:
        e = res[f"Order {order}"]
        check(len(e["rel_errs"]) == RICH_REFINE - 1 and all(
            np.isfinite(h).all() and h.shape == (RICH_BASE + 1, 4, 2)
            for h in e["histories"]), f"get_histories order {order}")
        slopes[order] = float(np.log2(e["rel_errs"][0] / e["rel_errs"][1]))
    phase("utils", f"get_histories, Rabi tf=2 pi, constant pulse, f64 on "
                   f"the card, nsteps {RICH_BASE}, {2 * RICH_BASE}, "
                   f"{4 * RICH_BASE}: Richardson errors "
                   + "; ".join(f"order {o} {res[f'Order {o}']['rel_errs']} "
                               f"(slope {slopes[o]:.3f}), seconds "
                               f"{[round(t, 4) for t in res[f'Order {o}']['elapsed']]}"
                               for o in RICH_ORDERS) + f"; {smi}")
    check(all(abs(slopes[o] - o) < SLOPE_TOL for o in RICH_ORDERS),
          f"get_histories: slopes {slopes}")

    npy = lambda x: x.detach().cpu().numpy()
    N = prob.N_tot_levels
    juq = qt.convert_juqbox(dict(
        Hconst=npy(prob.system_sym) + 1j * npy(prob.system_asym),
        Hsym_ops=list(npy(prob.sym_operators)),
        Hanti_ops=list(npy(prob.asym_operators)),
        Uinit=npy(prob.u0) + 1j * npy(prob.v0), T=VERLET_TF,
        nsteps=VERLET_NSTEPS[-1], N=prob.N_ess_levels,
        wmat_real=npy(prob.guard_subspace_projector)[:N, :N]), device=dev)
    check(torch.equal(juq.guard_subspace_projector,
                      prob.guard_subspace_projector),
          "convert_juqbox: the guard projector")
    ctrls = tuple(qt.BSpline2Control(10, VERLET_TF) for _ in range(3))
    ref = qt.eval_forward(juq, ctrls, pcof[0], 8,
                          save_every=VERLET_NSTEPS[-1])[-1]
    errs, v_secs = [], []
    for ns in VERLET_NSTEPS:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h = qt.models.verlet_forward(dataclasses.replace(juq, nsteps=ns),
                                     ctrls, pcof[0])
        torch.cuda.synchronize()
        v_secs.append(time.perf_counter() - t1)
        check(h.device == ref.device and h.shape == (ns + 1, 128, 8),
              "verlet_forward: a history on the card")
        errs.append(float((h[-1] - ref).norm() / ref.norm()))
    v_slopes = np.log2(np.array(errs[:-1]) / np.array(errs[1:]))
    phase("utils", f"verlet_forward, CNOT3 through the Juqbox fields, "
                   f"tf={VERLET_TF:g}, scenario 0's B-splines, f64 on the "
                   f"card, nsteps {list(VERLET_NSTEPS)}: relative error vs "
                   f"the order-8 Hermite forward at {VERLET_NSTEPS[-1]} "
                   f"steps {errs}, slopes {[round(float(v), 3) for v in v_slopes]}"
                   f", seconds {[round(t, 3) for t in v_secs]}; {smi}")
    check(all(abs(v - 2.0) < SLOPE_TOL for v in v_slopes),
          f"verlet_forward: slopes {v_slopes}")

    amps = [OPT_BOUND] * prob.N_operators
    n_est = qt.estimate_N_timesteps(prob, amps)
    H = npy(prob.system_sym) + 1j * npy(prob.system_asym)
    for a, sym, asym in zip(amps, npy(prob.sym_operators),
                            npy(prob.asym_operators)):
        H = H + a * sym + 1j * a * asym
    shortest = 2 * np.pi / np.abs(np.linalg.eigvals(H)).max()
    direct = int(np.ceil(prob.tf / shortest * 40))
    phase("utils", f"estimate_N_timesteps, CNOT3 tf={prob.tf:g}, controls at "
                   f"{OPT_BOUND:g}: {n_est} steps for 40 per shortest "
                   f"period ({qt.get_shortest_period(prob, amps):.6f}); "
                   f"phase {time.perf_counter() - t0:.1f} s; {smi}")
    check(n_est == direct, f"estimate_N_timesteps {n_est} != {direct}")


def _profile_ops(fn):
    """``(host-level aten events, all aten events, device busy ms, wall
    ms)`` of one ``fn()`` call under torch.profiler (after one warm call);
    host-level: aten events without an aten parent."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    top = nested = 0
    busy_ms = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_ms += e.time_range.elapsed_us() / 1e3
        elif e.name.startswith("aten::"):
            nested += 1
            parent = e.cpu_parent
            top += parent is None or not parent.name.startswith("aten::")
    return top, nested, busy_ms, wall_ms


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# The phases in the order they run; a row's phase (``_kernel_rows``'s
# ``driven_by``) is one of these or a part of one (ROW_PHASE).
PHASES = ("kernels", "wide", "main", "order8", "large_dense", "segmented",
          "optimize", "prefix", "lbfgs", "chunked", "forced", "multistart",
          "gmres", "gmres_large", "sharded", "utils")
ROW_PHASE = {"gmres_ad": "gmres", "gmres_optimize": "gmres",
             "chunked_long": "chunked"}


def _parse_phases(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ", ".join(PHASES)
                         + " (default: all; the kernel rows come from "
                           "'kernels')")
    chosen = ap.parse_args(argv).phases.split(",")
    unknown = set(chosen) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if {"prefix", "gmres"} & set(chosen) and "optimize" not in chosen:
        ap.error("prefix and gmres compare with the optimize phase's start "
                 "point: add optimize")
    return [p for p in PHASES if p in chosen]


def _main_setup(dev):
    """The main path's problem, controls, seed-0 control vectors and
    seed-1 target."""
    import qgd_tpu_torch as qt

    prob = qt.cnot3_problem(nsteps=NSTEPS, solver="schulz", dtype="float32",
                            schulz_iters=48, schulz_warm_budget=0,
                            device=dev)
    controls = tuple(qt.BSpline2Control(10, prob.tf) for _ in range(3))
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))
    return prob, controls, _main_pcof(dev), tgt


def main(argv=None):
    phases = _parse_phases(argv)
    t_start = time.perf_counter()
    smi = device_phase()
    import qgd_tpu_torch as qt

    build_phase()
    dev = torch.device("cuda", 0)
    prob, controls, pcof, tgt = _main_setup(dev)

    rows, start = [], None
    run = {
        "kernels": lambda: rows.extend(kernel_phase(prob, controls, pcof,
                                                    dev, smi)),
        "wide": lambda: wide_phase(dev, smi),
        "main": lambda: main_path_phase(prob, controls, pcof, tgt, dev,
                                        rows, smi),
        "order8": lambda: order8_phase(prob, controls, pcof, tgt, dev, rows,
                                       smi),
        "large_dense": lambda: large_dense_phase(pcof, dev, rows, smi),
        "segmented": lambda: segmented_phase(prob, controls, pcof, tgt, dev,
                                             rows, smi),
        "optimize": lambda: optimize_phase(rows, dev, smi),
        "prefix": lambda: prefix_phase(rows, start, dev, smi),
        "lbfgs": lambda: lbfgs_phase(dev, smi),
        "chunked": lambda: chunked_phase(rows, start, dev, smi),
        "forced": lambda: forced_phase(dev, smi),
        "multistart": lambda: multistart_phase(dev, smi),
        "gmres": lambda: gmres_phase(pcof, tgt, rows, start, dev, smi),
        "gmres_large": lambda: gmres_large_phase(pcof, rows, dev, smi),
        "sharded": lambda: sharded_phase(prob, controls, pcof, tgt, dev,
                                         rows, smi),
        "utils": lambda: utils_phase(prob, pcof, dev, smi),
    }
    for name in phases:
        t0 = time.perf_counter()
        result = run[name]()
        if name == "optimize":
            start = result
        phase("time", f"{name} {time.perf_counter() - t0:.1f} s")
    for row in rows:
        if ROW_PHASE.get(row["phase"], row["phase"]) in phases:
            check(row["launches"] > 0, f"{row['name']} was not launched by "
                                       f"its phase")
    phase("done", f"phases {', '.join(phases)} passed in "
                  f"{time.perf_counter() - t_start:.1f} s; {smi}")

    print(json.dumps({"kernels": rows}))
    print(smi)
    ok = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if len(phases) < len(PHASES):
        ok["phases"] = phases
    print(json.dumps(ok), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--split-worker"]:
        # a process of the sharded phase's (b); its parent checks it
        _split_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    try:
        main()
    except Exception as exc:  # report and fail: no phase's failure is hidden
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr, flush=True)
        raise
