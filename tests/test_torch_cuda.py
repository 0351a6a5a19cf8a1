"""The CUDA stage kernels of qgd_tpu_torch against their plain PyTorch
versions, on the card. Marked ``cuda``; each test skips (inside the
``cuda`` fixture) where no GPU is present. This file imports no JAX, so
it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import qgd_tpu_torch as qt
from qgd_tpu_torch.ops import stage_kernels as sk

pytestmark = pytest.mark.cuda

# f32 kernel vs f32 plain version: the same arithmetic in another
# summation order, so the difference is f32 roundoff of the largest terms.
REL_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _rel_err(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def _inputs(seed, B, m, n, b, device, scale=0.3):
    rng = np.random.default_rng(seed)
    A = torch.tensor(rng.standard_normal((B, m, n, n)) * scale,
                     dtype=torch.float32, device=device)
    W = torch.tensor(rng.standard_normal((B, n, b)), dtype=torch.float32,
                     device=device)
    return A, W


# n <= 128 with n % 4 == 0 takes the staged LHS and stream RHS kernels;
# the ragged n = 130 and n = 256 (above the whole-matrix staging limit)
# take the level kernels of both (one launch per recursion level).
SHAPES = [(3, 16, 4), (2, 130, 11), (4, 64, 8), (2, 256, 8)]


# Each order is one test item and runs every shape of SHAPES in turn,
# every shape checked before the item fails, and the failure names each
# shape that missed: the number of items the suite collects sets how
# pytest-xdist chunks it at the start (see ROADMAP "Little room in
# Tier-1").
@pytest.mark.parametrize("m", [1, 2, 3, 6])
def test_lhs_kernel_matches_plain(cuda, m):
    """The LHS kernel and its pair variant (the backward's (R, L) from one
    recursion), each against its plain version, at every shape."""
    missed = []
    for B, n, b in SHAPES:
        A, _ = _inputs(m, B, m, n, b, cuda)
        out = qt.ops.hermite_lhs_matrix_kernel_call(A, 0.05, m)
        R, L = qt.ops.hermite_stage_pair_kernel_call(A, 0.05, m)
        torch.cuda.synchronize()
        refs = (sk.lhs_matrix_plain(A, 0.05, m),
                *sk.stage_pair_plain(A, 0.05, m))
        for name, x, ref in zip(("lhs", "R", "L"), (out, R, L), refs):
            err = _rel_err(x, ref)
            if not err <= REL_TOL:
                missed.append((name, B, n, b, err))
    assert not missed, missed


@pytest.mark.parametrize("m", [1, 2, 3, 6])
def test_rhs_kernel_matches_plain(cuda, m):
    missed = []
    for B, n, b in SHAPES:
        A, W = _inputs(10 + m, B, m, n, b, cuda)
        out = qt.ops.hermite_rhs_kernel_call(A, W, 0.05, m)
        torch.cuda.synchronize()
        err = _rel_err(out, sk.rhs_plain(A, W, 0.05, m))
        if not err <= REL_TOL:
            missed.append((B, n, b, err))
    assert not missed, missed


def _main_path_stack(device):
    """The generator stacks (256, 2, 128, 128) that the main path hands the
    kernels at step 500 (CNOT3, nsteps = 1000, three BSpline2Control(10)
    with seed-0 parameters), and its step as a tensor on ``device``."""
    from qgd_tpu_torch.forward import _time_grid

    prob = qt.cnot3_problem(nsteps=1000, solver="schulz", dtype="float32",
                            schulz_warm_budget=0, device=device)
    ctrls = tuple(qt.BSpline2Control(10, prob.tf) for _ in range(3))
    pcof = torch.tensor(
        np.random.default_rng(0).standard_normal((256, 60)) * 0.01,
        dtype=torch.float64, device=device)
    _, ts = _time_grid(prob)
    P, Q = qt.control_tables(ctrls, pcof, ts[500:501], 2)
    A = qt.assemble_generator_stack(qt.working_problem(prob),
                                    P[:, 0].float(), Q[:, 0].float(), 2)
    dt = torch.tensor(prob.tf / prob.nsteps, dtype=torch.float32,
                      device=device)
    return A.contiguous(), dt


def test_kernels_at_main_path_shape(cuda):
    """B = 256 scenarios, 2N = 128, m = 2, b = 8, at the CNOT3 step size;
    the pair kernel launched once per call, its L within REL_TOL of the
    LHS kernel's output (its product on the tensor cores in split TF32,
    the LHS kernel's in FP32 FMA). Precision: on the main path's own
    stack, the pair's largest error against the float64 pair, over max
    |ref|, is at most twice the LHS kernel's error on L and at most 1e-6
    (single-pass TF32 misses both by orders of magnitude)."""
    A, W = _inputs(3, 256, 2, 128, 8, cuda, scale=1.0)
    dt = torch.tensor(0.55, dtype=torch.float32, device=cuda)
    lhs = qt.ops.hermite_lhs_matrix_kernel_call(A, dt, 2)
    assert _rel_err(lhs, sk.lhs_matrix_plain(A, dt, 2)) <= REL_TOL
    assert _rel_err(qt.ops.hermite_rhs_kernel_call(A, W, dt, 2),
                    sk.rhs_plain(A, W, dt, 2)) <= REL_TOL
    sk.reset_launch_counts()
    R, L = qt.ops.hermite_stage_pair_kernel_call(A, dt, 2)
    assert sk.launch_counts()["hermite_stage_pair"] == 1
    for x, ref in zip((R, L), sk.stage_pair_plain(A, dt, 2)):
        assert _rel_err(x, ref) <= REL_TOL
    assert _rel_err(L, lhs) <= REL_TOL

    A, dt = _main_path_stack(cuda)
    R, L = qt.ops.hermite_stage_pair_kernel_call(A, dt, 2)
    lhs = qt.ops.hermite_lhs_matrix_kernel_call(A, dt, 2)
    R64, L64 = sk.stage_pair_plain(A.double(), dt.double(), 2)
    pair_err = max(_rel_err(R.double(), R64), _rel_err(L.double(), L64))
    lhs_err = _rel_err(lhs.double(), L64)
    assert pair_err <= 2 * lhs_err and pair_err <= 1e-6, (pair_err, lhs_err)


def test_kernel_backward_is_plain_vjp(cuda):
    A, W = _inputs(5, 3, 2, 16, 4, cuda, scale=0.1)
    dt = torch.tensor(0.37, dtype=torch.float32, device=cuda,
                      requires_grad=True)

    def grads(fn):
        a = A.clone().requires_grad_(True)
        w = W.clone().requires_grad_(True)
        d = dt.detach().clone().requires_grad_(True)
        loss = (fn(a, w, d) ** 2).sum()
        return torch.autograd.grad(loss, (a, w, d), allow_unused=True)

    lhs_k = grads(lambda a, w, d:
                  qt.ops.hermite_lhs_matrix_kernel_call(a, d, 2))
    lhs_p = grads(lambda a, w, d: sk.lhs_matrix_plain(a, d, 2))
    rhs_k = grads(lambda a, w, d: qt.ops.hermite_rhs_kernel_call(a, w, d, 2))
    rhs_p = grads(lambda a, w, d: sk.rhs_plain(a, w, d, 2))
    for gk, gp in list(zip(lhs_k, lhs_p)) + list(zip(rhs_k, rhs_p)):
        if gp is None:
            assert gk is None
            continue
        assert _rel_err(gk, gp) <= 1e-4


def test_device_dt_and_number_dt_agree(cuda):
    """``dt`` on the card is read by the kernels in place; a number goes by
    value: both give the same f32 scales."""
    A, W = _inputs(8, 3, 3, 64, 8, cuda)
    dt = torch.tensor(0.05, dtype=torch.float32, device=cuda)
    assert torch.equal(qt.ops.hermite_lhs_matrix_kernel_call(A, dt, 3),
                       qt.ops.hermite_lhs_matrix_kernel_call(A, 0.05, 3))
    assert torch.equal(qt.ops.hermite_rhs_kernel_call(A, W, dt, 3),
                       qt.ops.hermite_rhs_kernel_call(A, W, 0.05, 3))


def _device_kernels(fn):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def test_main_path_wrappers_issue_one_device_kernel(cuda):
    """At m = 2 with ``dt`` on the card, as the main path calls them, each
    wrapper call issues exactly one device kernel (torch.profiler)."""
    A, W = _inputs(9, 4, 2, 128, 8, cuda)
    dt = torch.tensor(0.55, dtype=torch.float32, device=cuda)
    lhs = _device_kernels(
        lambda: qt.ops.hermite_lhs_matrix_kernel_call(A, dt, 2))
    rhs = _device_kernels(lambda: qt.ops.hermite_rhs_kernel_call(A, W, dt, 2))
    pair = _device_kernels(
        lambda: qt.ops.hermite_stage_pair_kernel_call(A, dt, 2))
    assert len(lhs) == 1 and "lhs_staged_kernel" in lhs[0], lhs
    assert len(rhs) == 1 and "rhs_stream_kernel" in rhs[0], rhs
    assert len(pair) == 1 and "stage_pair_tf32_kernel" in pair[0], pair


def test_kernels_refuse_what_they_do_not_take(cuda):
    A, W = _inputs(6, 2, 2, 16, 4, cuda)
    with pytest.raises(ValueError, match="no kernel takes"):
        # m = 17 is past the kernels' 16 levels (order 32)
        qt.ops.hermite_lhs_matrix_kernel_call(
            torch.zeros((1, 17, 16, 16), device=cuda), 0.1, 17)
    with pytest.raises(TypeError):
        qt.ops.hermite_lhs_matrix_kernel_call(A.double(), 0.1, 2)
    with pytest.raises(ValueError):
        qt.ops.hermite_lhs_matrix_kernel_call(
            A.transpose(-1, -2), 0.1, 2)
    with pytest.raises(ValueError):
        qt.ops.hermite_rhs_kernel_call(A, W.cpu(), 0.1, 2)
    with pytest.raises(ValueError):
        qt.ops.hermite_rhs_kernel_call(A, W.transpose(-1, -2), 0.1, 2)


# (B, m, n, b) whose state levels outgrow a block's shared memory: 2N =
# 2048 at order 4, 16 columns at 512 levels, orders 10 and 12 at 512
# levels (the last at a ragged n past 1024)
WIDE_SHAPES = [(1, 2, 2048, 8), (1, 2, 1024, 16), (1, 5, 1024, 8),
               (1, 6, 2000, 8)]


def _scaled_inputs(seed, B, m, n, b, device):
    """Entries ~ 1/sqrt(n): the stack's norms stay O(1) at every n."""
    return _inputs(seed, B, m, n, b, device, scale=1.0 / np.sqrt(n))


def test_rhs_kernel_at_wide_shapes(cuda):
    """The RHS kernel takes every shape with m <= 16: the level path keeps
    the state levels in device memory, not in shared memory."""
    dt = torch.tensor(0.1, dtype=torch.float32, device=cuda)
    for B, m, n, b in WIDE_SHAPES:
        A, W = _scaled_inputs(30 + m, B, m, n, b, cuda)
        out = qt.ops.hermite_rhs_kernel_call(A, W, dt, m)
        torch.cuda.synchronize()
        assert out.shape == (B, n, b)
        assert _rel_err(out, sk.rhs_plain(A, W, dt, m)) <= REL_TOL, (B, m, n,
                                                                     b)


def test_lhs_level_kernel_at_large_and_order8_shapes(cuda):
    """The LHS level kernel at 2N = 1024 (B = 1: 128 x 64 tiles; B = 20:
    128 x 128) and at order 8 on the main path's width (the staged launch,
    then levels 2 and 3); the pair variant at the same shapes."""
    dt = torch.tensor(0.1, dtype=torch.float32, device=cuda)
    for B, m, n in [(1, 2, 1024), (20, 2, 1024), (256, 4, 128)]:
        A, _ = _scaled_inputs(40 + B, B, m, n, 8, cuda)
        out = qt.ops.hermite_lhs_matrix_kernel_call(A, dt, m)
        pair = qt.ops.hermite_stage_pair_kernel_call(A, dt, m)
        torch.cuda.synchronize()
        assert _rel_err(out, sk.lhs_matrix_plain(A, dt, m)) <= REL_TOL, (B,
                                                                         m, n)
        for x, ref in zip(pair, sk.stage_pair_plain(A, dt, m)):
            assert _rel_err(x, ref) <= REL_TOL, (B, m, n)


def test_large_dense_route_on_the_card(cuda):
    """512 levels (2N = 1024, 8 columns), 4 steps, f32 Schulz with the main
    path's settings at L = 2 and L = 1: the LHS level kernel and the RHS
    level kernel inside the route, against float64 LU on the card."""
    freqs = 2 * np.pi * np.array([4.10336, 4.81831, 7.8447])
    xi = 2 * np.pi * np.array([0.2198, 0.2252, 0.001])
    x12, x13, x23 = 2 * np.pi * np.array([0.01, 0.001, 0.001])
    kerr = np.array([[xi[0], x12, x13], [x12, xi[1], x23],
                     [x13, x23, xi[2]]])

    def problem(**kw):
        return qt.DispersiveProblem((8, 8, 8), (2, 2, 2), freqs, freqs, kerr,
                                    0.4, 4, device=cuda, **kw)

    prob = problem(solver="schulz", dtype="float32", schulz_iters=48,
                   schulz_warm_budget=0)
    ctrls = tuple(qt.BSpline2Control(10, 0.4) for _ in range(3))
    pcof = np.random.default_rng(0).standard_normal((1, 60)) * 0.01
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((512, 8)) + 1j * rng.standard_normal((512, 8))
    (fj1, fg, _), fgrad = qt.segmented_objective_and_gradient(
        problem(), ctrls, pcof, tgt, 4)
    for n_seg, lhs_calls in ((2, 4), (4, 4)):
        sk.reset_launch_counts()
        (j1, g, _), grad = qt.segmented_objective_and_gradient(
            prob, ctrls, pcof, tgt, 4, n_segments=n_seg)
        assert sk.launch_counts()["hermite_lhs_matrix"] == lhs_calls
        assert float((j1 + g - fj1 - fg).abs().max()) <= 1e-4
        assert float((grad - fgrad).norm() / fgrad.norm()) <= 1e-3


def test_launch_counters_count_kernel_launches(cuda):
    A, W = _inputs(7, 2, 2, 16, 4, cuda)
    sk.reset_launch_counts()
    qt.ops.hermite_lhs_matrix_kernel_call(A, 0.1, 2)
    qt.ops.hermite_lhs_matrix_kernel_call(A, 0.1, 2, sign=1.0)
    qt.ops.hermite_rhs_kernel_call(A, W, 0.1, 2)
    qt.ops.hermite_rhs_kernel_call(A, W, 0.1, 2)
    qt.ops.hermite_stage_pair_kernel_call(A, 0.1, 2)
    sk.lhs_matrix_plain(A, 0.1, 2)
    sk.stage_pair_plain(A, 0.1, 2)
    assert sk.launch_counts() == {"hermite_lhs_matrix": 2, "hermite_rhs": 2,
                                  "hermite_stage_pair": 1}
    assert sk.lhs_launches_by_sign() == {"-1": 1, "+1": 1}


def test_slice_kernel_route_matches_plain_route(cuda, monkeypatch):
    """CNOT3 at full width, 8 steps, 2 scenarios, f32: the kernel route
    against the plain route on the card, the LHS and RHS wrappers launched
    once per forward step, the pair once per backward step. The step loops
    run in blocks of 4 steps (the block target set to 4): a call captures
    both block programs, a later call with the same SegmentGraphs replays
    them, bit for bit (the replays counted into the launches)."""
    from qgd_tpu_torch import segmented

    monkeypatch.setattr(segmented, "_BLOCK_STEPS", 4)
    prob = qt.cnot3_problem(tf=4.4, nsteps=8, solver="schulz",
                            dtype="float32", schulz_iters=48,
                            schulz_warm_budget=0, device=cuda)
    ctrls = tuple(qt.BSpline2Control(10, prob.tf) for _ in range(3))
    pcof = np.random.default_rng(0).standard_normal((2, 60)) * 0.01
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))
    per_call = {"hermite_lhs_matrix": 8, "hermite_rhs": 8,
                "hermite_stage_pair": 8}
    graphs = qt.SegmentGraphs()
    calls = []
    for _ in range(2):
        sk.reset_launch_counts()
        calls.append(qt.segmented_objective_and_gradient(
            prob, ctrls, pcof, tgt, 4, graphs=graphs))
        assert sk.launch_counts() == per_call
    assert graphs.stats()["graphs"] == 2
    assert graphs.stats()["replays"] == {"fwd": 3, "bwd": 3}
    _replay_matches_capture(*calls)
    (j1_k, g_k, _), grad_k = calls[0]
    sk.reset_launch_counts()
    (j1_p, g_p, _), grad_p = qt.segmented_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4, use_kernels=False)
    assert sk.launch_counts() == {"hermite_lhs_matrix": 0, "hermite_rhs": 0,
                                  "hermite_stage_pair": 0}
    assert float((j1_k - j1_p).abs().max()) <= 1e-5
    assert float((g_k - g_p).abs().max()) <= 1e-5
    assert float((grad_k - grad_p).norm() / grad_p.norm()) <= 1e-4


def _replay_matches_capture(first, later):
    """The call that captured a route's programs and a later call that
    replays them: the objective bit for bit, the gradient equal or within
    1e-15 relative."""
    (j1, g, _), grad = first
    (rj1, rg, _), rgrad = later
    assert torch.equal(j1, rj1) and torch.equal(g, rg)
    assert float((grad - rgrad).norm() / grad.norm()) <= 1e-15


@pytest.mark.parametrize("B", [1, 1000, 5500])
def test_lhs_kernel_at_hoisted_batch(cuda, B):
    """The plain route's hoisted build: one launch over every step's
    stage, B = S·T (5500 = CNOT3's published horizon): about 21 waves of
    264 blocks, 720 MB read and 360 MB written in one call. The pair
    kernel at B = 1 (GMRES's adjoint, 32 x 32 tiles) and B = 100 (a
    chunked segment, 64 x 64 tiles) on the same stacks."""
    A, _ = _inputs(20, B, 2, 128, 8, cuda, scale=1.0)
    dt = torch.tensor(0.1, dtype=torch.float32, device=cuda)
    out = qt.ops.hermite_lhs_matrix_kernel_call(A, dt, 2)
    torch.cuda.synchronize()
    assert _rel_err(out, sk.lhs_matrix_plain(A, dt, 2)) <= REL_TOL
    Ap = A[:min(B, 100)].contiguous()
    for x, ref in zip(qt.ops.hermite_stage_pair_kernel_call(Ap, dt, 2),
                      sk.stage_pair_plain(Ap, dt, 2)):
        assert _rel_err(x, ref) <= REL_TOL
    # the last matrix alone: no cross-talk between blocks at the far end
    last = qt.ops.hermite_lhs_matrix_kernel_call(A[-1:].contiguous(), dt, 2)
    assert torch.equal(out[-1:], last)


@pytest.mark.parametrize("B", [1, 2])
def test_rhs_kernel_at_single_start_batch(cuda, B):
    """optimize_gate's explicit half: one control vector (B = 1)."""
    A, W = _inputs(21, B, 2, 128, 8, cuda, scale=1.0)
    dt = torch.tensor(0.1, dtype=torch.float32, device=cuda)
    out = qt.ops.hermite_rhs_kernel_call(A, W, dt, 2)
    torch.cuda.synchronize()
    assert _rel_err(out, sk.rhs_plain(A, W, dt, 2)) <= REL_TOL


def test_plain_route_on_the_card_matches_cpu_f64(cuda):
    """CNOT3, 8 steps, 2 carrier-controlled scenarios: the f32 kernel
    route of objective_and_gradient on the card against the float64 LU
    route on the CPU, with one hoisted LHS launch and one RHS launch per
    step."""
    freqs = qt.cnot3_carrier_frequencies()
    ctrls = [qt.CarrierControl(qt.BSpline2Control(10, 4.4), f) for f in freqs]
    pcof = np.random.default_rng(0).uniform(-0.002, 0.002, (2, 180))
    tgt = qt.cnot3_target(tf=4.4)
    prob = qt.cnot3_problem(tf=4.4, nsteps=8, solver="schulz",
                            dtype="float32", schulz_warm_budget=0,
                            device=cuda)
    sk.reset_launch_counts()
    (j1, g, _), grad = qt.objective_and_gradient(prob, ctrls, pcof, tgt, 4)
    # the adjoint's pairs at the 7 interior points, hoisted: one launch
    assert sk.launch_counts() == {"hermite_lhs_matrix": 1, "hermite_rhs": 8,
                                  "hermite_stage_pair": 1}
    ref = qt.cnot3_problem(tf=4.4, nsteps=8, device="cpu")
    (rj1, rg, _), rgrad = qt.objective_and_gradient(ref, ctrls, pcof, tgt, 4)
    assert float(((j1 + g).cpu() - (rj1 + rg)).abs().max()) <= 1e-4
    assert float((grad.cpu() - rgrad).norm() / rgrad.norm()) <= 1e-3


@pytest.mark.parametrize("B,sign", [(10240, -1.0), (275, -1.0), (275, 1.0)])
def test_lhs_kernel_at_segment_and_prefix_batches(cuda, B, sign):
    """One segment's hoisted build: L = 40 for 256 scenarios (B = 10240,
    about 1.3 GB of stack in); the prefix route's R (sign +1) and M
    (sign -1) at L = 275, one wave and 11 blocks past it; the backward's
    pair at the same batches."""
    A, _ = _inputs(22, B, 2, 128, 8, cuda, scale=1.0)
    dt = torch.tensor(0.1, dtype=torch.float32, device=cuda)
    out = qt.ops.hermite_lhs_matrix_kernel_call(A, dt, 2, sign)
    torch.cuda.synchronize()
    assert _rel_err(out, sk.lhs_matrix_plain(A, dt, 2, sign)) <= REL_TOL
    if sign == -1.0:
        for x, ref in zip(qt.ops.hermite_stage_pair_kernel_call(A, dt, 2),
                          sk.stage_pair_plain(A, dt, 2)):
            assert _rel_err(x, ref) <= REL_TOL
    last = qt.ops.hermite_lhs_matrix_kernel_call(A[-1:].contiguous(), dt, 2,
                                                 sign)
    assert torch.equal(out[-1:], last)


def _cnot3_slice(cuda, nsteps):
    prob = qt.cnot3_problem(tf=0.55 * nsteps, nsteps=nsteps, solver="schulz",
                            dtype="float32", schulz_iters=48,
                            schulz_warm_budget=0, device=cuda)
    ctrls = tuple(qt.BSpline2Control(10, prob.tf) for _ in range(3))
    pcof = np.random.default_rng(0).standard_normal((3, 60)) * 0.01
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))
    return prob, ctrls, pcof, tgt


def test_general_segment_length_on_the_card(cuda):
    """CNOT3, 24 steps in 3 segments of 8, 3 scenarios, f32: the kernel
    route against the plain route and against L = 1; the LHS kernel once
    per segment in the forward and once in the re-forward, the RHS kernel
    once per step in each, the pair kernel once per segment. At 80 steps
    in 2 segments of L = 40, a call that replays the captured segment
    programs against the call that captured them, bit for bit."""
    prob, ctrls, pcof, tgt = _cnot3_slice(cuda, 24)
    sk.reset_launch_counts()
    (j1, g, _), grad = qt.segmented_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4, n_segments=3)
    assert sk.launch_counts() == {"hermite_lhs_matrix": 6, "hermite_rhs": 48,
                                  "hermite_stage_pair": 3}
    prob80, ctrls80, pcof80, tgt80 = _cnot3_slice(cuda, 80)
    graphs = qt.SegmentGraphs()
    calls = [qt.segmented_objective_and_gradient(
        prob80, ctrls80, pcof80, tgt80, 4, n_segments=2, graphs=graphs)
        for _ in range(2)]
    assert graphs.stats()["replays"] == {"fwd": 3, "bwd": 3}
    _replay_matches_capture(*calls)
    for kw in (dict(n_segments=3, use_kernels=False), dict(n_segments=24)):
        (rj1, rg, _), rgrad = qt.segmented_objective_and_gradient(
            prob, ctrls, pcof, tgt, 4, **kw)
        assert float((j1 + g - rj1 - rg).abs().max()) <= 1e-5
        assert float((grad - rgrad).norm() / rgrad.norm()) <= 1e-4


def test_prefix_route_on_the_card(cuda):
    """The prefix route in f32 with its kernels (3 LHS launches per
    segment, no RHS) against its plain route and the segmented route."""
    prob, ctrls, pcof, tgt = _cnot3_slice(cuda, 24)
    sk.reset_launch_counts()
    (j1, g, _), grad = qt.prefix_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4, n_segments=2)
    assert sk.launch_counts() == {"hermite_lhs_matrix": 6, "hermite_rhs": 0,
                                  "hermite_stage_pair": 2}
    assert sk.lhs_launches_by_sign() == {"-1": 4, "+1": 2}
    (pj1, pg, _), pgrad = qt.prefix_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4, n_segments=2, use_kernels=False)
    (sj1, sg, _), sgrad = qt.segmented_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4)
    for oj, og in ((pj1 + pg, pgrad), (sj1 + sg, sgrad)):
        assert float((j1 + g - oj).abs().max()) <= 1e-5
        assert float((grad - og).norm() / og.norm()) <= 1e-4


def test_forced_gradient_on_the_card(cuda):
    """Forward mode on the card: in float64 the forced gradient meets the
    adjoint gate; in float32, through the kernels' forward-mode rules, the
    forced gradient (CNOT3, 100 steps of 0.55, 60 parameters) and the AD
    Hessian (4 steps, 24 parameters) come within 1e-3 of float64, at the
    sizes of chip_smoke.py's forced phase."""
    prob, ctrls, pcof, tgt = _cnot3_slice(cuda, 4)
    prob64 = qt.cnot3_problem(tf=2.2, nsteps=4, device=cuda)
    g_for = qt.eval_grad_forced(prob64, ctrls, pcof[0], tgt, 4)
    g_adj = qt.discrete_adjoint(prob64, ctrls, pcof[0], tgt, 4)
    scale = max(1.0, float(g_adj.abs().max()))
    assert float((g_for - g_adj).abs().max()) <= 1e-14 * scale + 1e-13 * float(
        g_adj.abs().max())

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    prob, ctrls, pcof, _ = _cnot3_slice(cuda, 100)
    prob64 = dataclasses.replace(prob, dtype="float64")
    tgt = qt.cnot3_target(tf=prob.tf)
    sk.reset_launch_counts()
    g32 = qt.eval_grad_forced(prob, ctrls, pcof[0], tgt, 4)
    assert sk.launch_counts()["hermite_lhs_matrix"] > 0
    assert rel(g32, qt.eval_grad_forced(prob64, ctrls, pcof[0], tgt, 4)
               ) <= 1e-3
    prob = qt.cnot3_problem(tf=2.2, nsteps=4, solver="schulz",
                            dtype="float32", schulz_iters=48,
                            schulz_warm_budget=0, device=cuda)
    ctrls = tuple(qt.BSpline2Control(4, prob.tf) for _ in range(3))
    pcof = np.random.default_rng(1).standard_normal(24) * 0.05
    tgt = qt.cnot3_target(tf=2.2)
    sk.reset_launch_counts()
    H32 = qt.eval_hessian(prob, ctrls, pcof, tgt, 4)
    assert sk.launch_counts()["hermite_stage_pair"] > 0
    H64 = qt.eval_hessian(dataclasses.replace(prob, dtype="float64"), ctrls,
                          pcof, tgt, 4)
    assert rel(H32, H64) <= 1e-3


def test_lbfgs_method_on_the_card(cuda):
    """optimize_gate(method="lbfgs") on the card (Rabi SWAP, f64): the
    objective falls and the box holds."""
    prob = qt.construct_rabi_prob(nsteps=40, device=cuda)
    hist = qt.optimize_gate(prob, qt.GRAPEControl(1, prob.tf),
                            np.array([0.4, 0.1]),
                            np.array([[0, 1], [1, 0]], dtype=complex),
                            order=4, method="lbfgs", maxIter=4,
                            pcof_L=-0.45, pcof_U=0.45, print_level=0)
    assert hist.obj_value[-1] < hist.obj_value[0]
    assert np.abs(np.asarray(hist.pcof)).max() <= 0.45


@pytest.mark.parametrize("B,n,transposed", [(256, 128, False),
                                            (256, 128, True),
                                            (1, 1024, False)],
                         ids=["stream-256", "stream-256-transposed",
                              "ring-1024"])
def test_rhs_kernel_at_gmres_shapes(cuda, B, n, transposed):
    """The GMRES operator: the RHS kernel at step sign -1 on the main
    path's stack (B = 256, n = 128), on its transposed stack (the reverse
    solve's), and at n = 1024 (512 levels, the level path)."""
    A, W = _inputs(23 + n, B, 2, n, 8, cuda, scale=128.0 / n)
    if transposed:
        A = A.transpose(-1, -2).contiguous()
    dt = torch.tensor(0.1, dtype=torch.float32, device=cuda)
    sk.reset_launch_counts()
    out = qt.ops.hermite_rhs_kernel_call(A, W, dt, 2, sign=-1.0)
    torch.cuda.synchronize()
    assert sk.rhs_launches_by_sign() == {"-1": 1, "+1": 0}
    assert _rel_err(out, sk.rhs_plain(A, W, dt, 2, -1.0)) <= REL_TOL


def test_gmres_route_on_the_card(cuda):
    """CNOT3, 8 steps, 2 scenarios, f32 GMRES with the diagonal
    preconditioner: one explicit half (sign +1) and gmres_iters + 1
    operator applications (sign -1) per step; the history against the
    float64 LU route, and the autograd gradient (transposed solves on the
    card) against the Lagrange one."""
    prob = qt.cnot3_problem(tf=4.4, nsteps=8, solver="gmres",
                            preconditioner_type="diagonal", dtype="float32",
                            device=cuda)
    ctrls = tuple(qt.BSpline2Control(10, 4.4) for _ in range(3))
    pcof = np.random.default_rng(0).standard_normal((2, 60)) * 0.01
    sk.reset_launch_counts()
    h = qt.eval_forward(prob, ctrls, pcof, 4)
    assert sk.rhs_launches_by_sign() == {"-1": 8 * 21, "+1": 8}
    ref = qt.eval_forward(qt.cnot3_problem(tf=4.4, nsteps=8, device=cuda),
                          ctrls, pcof, 4)
    assert float((h.double() - ref).abs().max()) <= 1e-5
    tgt = qt.cnot3_target(tf=4.4)
    g_ad = qt.discrete_adjoint(prob, ctrls, pcof, tgt, 4, method="ad")
    g_la = qt.discrete_adjoint(prob, ctrls, pcof, tgt, 4)
    assert float((g_ad - g_la).norm() / g_la.norm()) <= 1e-3


@pytest.mark.parametrize("B", [1, 256])
def test_rhs_kernel_at_column_split_width(cuda, B):
    """The explicit half of one rank's gate columns when CNOT3's 8 columns
    split 4 + 4 over two ranks (``parallel.sharded``): the RHS kernel at
    b = 4, for one control vector and for the main path's 256."""
    A, W = _inputs(31 + B, B, 2, 128, 4, cuda, scale=1.0)
    dt = torch.tensor(0.55, dtype=torch.float32, device=cuda)
    out = qt.ops.hermite_rhs_kernel_call(A, W, dt, 2)
    torch.cuda.synchronize()
    assert _rel_err(out, sk.rhs_plain(A, W, dt, 2)) <= REL_TOL


def test_sharded_call_on_one_nccl_rank(cuda):
    """batched_objective_and_grad on a 1 x 1 mesh of one NCCL rank against
    the unsharded segmented call on the same control vectors (CNOT3, 20
    steps, f32): a one-rank sum is the identity, the arithmetic is the
    same, so only a library's choice of summation order between two calls
    could part them (chip_smoke.py's gate: 1e-6 on the objective, 1e-5
    relative on the gradient)."""
    import socket

    import torch.distributed as dist
    from qgd_tpu_torch.parallel import (batched_objective_and_grad,
                                        initialize_distributed, make_mesh)

    if dist.is_initialized():
        pytest.skip("torch.distributed is already initialized here")
    prob = qt.cnot3_problem(tf=11.0, nsteps=20, solver="schulz",
                            dtype="float32", schulz_iters=48,
                            schulz_warm_budget=0, device=cuda)
    ctrls = tuple(qt.BSpline2Control(10, 11.0) for _ in range(3))
    pcof = np.random.default_rng(0).standard_normal((4, 60)) * 0.01
    tgt = qt.cnot3_target(tf=11.0)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0, device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        vals, grads = batched_objective_and_grad(
            prob, ctrls, pcof, tgt, make_mesh(1, 1), 4,
            gradient_method="segmented")
    finally:
        dist.destroy_process_group()
    (j1, guard, _), grad = qt.segmented_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4)
    assert float((vals - (j1 + guard)).abs().max()) <= 1e-6
    assert float((grads - grad).norm() / grad.norm()) <= 1e-5


def test_chunked_route_replays_graphs(cuda):
    """The chunked route on a CNOT3 slice (48 steps, f32 Schulz, 6
    segments of 8 in chunks of 2): each segment program captured once and
    replayed for every later segment and evaluation, against the eager
    segmented route (chip_smoke.py's gate: 1e-6 and 1e-5 relative). The
    launch counters count the replays' launches: 2 LHS per segment
    (forward and re-forward) and 2 RHS per step in each evaluation, the
    capture itself none. GMRES runs its programs eagerly: its least
    squares is an SVD, which no graph can capture."""
    from qgd_tpu_torch.chunked import SegmentGraphs
    from qgd_tpu_torch.ops.gmres import _lstsq_min_norm

    prob, ctrls, pcof, tgt = _cnot3_slice(cuda, 48)
    kw = dict(n_segments=6, ridge_penalty_strength=1e-2)
    graphs = SegmentGraphs()
    for _ in range(2):
        sk.reset_launch_counts()
        (j1, g, r), grad = qt.chunked_objective_and_gradient(
            prob, ctrls, pcof[0], tgt, 4, max_dispatch_steps=16,
            graphs=graphs, **kw)
        assert sk.launch_counts() == {"hermite_lhs_matrix": 12,
                                      "hermite_rhs": 96,
                                      "hermite_stage_pair": 6}
    stats = graphs.stats()
    assert stats["graphs"] == 2 and stats["replays"] == {"fwd": 11, "bwd": 11}
    (sj1, sg, sr), sgrad = qt.segmented_objective_and_gradient(
        prob, ctrls, pcof[0], tgt, 4, **kw)
    obj, sobj = float(j1 + g + r), float(sj1 + sg + sr)
    assert abs(obj - sobj) <= 1e-6 * abs(sobj)
    assert float((grad - sgrad.cpu()).norm() / sgrad.norm()) <= 1e-5

    H = torch.randn(1, 5, 4, device=cuda)
    beta = torch.ones(1, device=cuda)
    _lstsq_min_norm(H, beta)
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            _lstsq_min_norm(H, beta)
    gprob = qt.cnot3_problem(tf=0.55 * 48, nsteps=48, solver="gmres",
                             gmres_iters=8, preconditioner_type="diagonal",
                             dtype="float32", device=cuda)
    graphs = SegmentGraphs()
    (j1, g, r), grad = qt.chunked_objective_and_gradient(
        gprob, ctrls, pcof[0], tgt, 4, max_dispatch_steps=16, graphs=graphs,
        **kw)
    assert graphs.stats()["graphs"] == 0
    (sj1, sg, sr), sgrad = qt.segmented_objective_and_gradient(
        gprob, ctrls, pcof[0], tgt, 4, **kw)
    assert abs(float(j1 + g + r) - float(sj1 + sg + sr)) <= 1e-6
    assert float((grad - sgrad.cpu()).norm() / sgrad.norm()) <= 1e-5


def test_chunked_route_float64_on_the_card(cuda):
    """float64 LU on the card (the graphs hold cuSOLVER's LU): the chunked
    route against the eager segmented route within 1e-12 relative, as the
    JAX package pins its own chunked route on the CPU (about 1e-14)."""
    from qgd_tpu_torch.chunked import SegmentGraphs

    prob = qt.cnot3_problem(tf=0.55 * 48, nsteps=48, device=cuda)
    ctrls = tuple(qt.BSpline2Control(10, prob.tf) for _ in range(3))
    pcof = np.random.default_rng(0).standard_normal(60) * 0.01
    tgt = qt.cnot3_target(tf=prob.tf)
    kw = dict(n_segments=12, ridge_penalty_strength=1e-2)
    graphs = SegmentGraphs()
    (j1, g, r), grad = qt.chunked_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4, segments_per_chunk=3, graphs=graphs, **kw)
    assert graphs.stats()["graphs"] == 2
    (sj1, sg, sr), sgrad = qt.segmented_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4, **kw)
    for x, ref in ((j1, sj1), (g, sg), (r, sr)):
        assert abs(float(x) - float(ref)) <= 1e-12 * abs(float(ref))
    assert float((grad - sgrad.cpu()).norm() / sgrad.norm()) <= 1e-12
