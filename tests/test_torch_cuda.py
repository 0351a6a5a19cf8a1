"""The CUDA stage kernels of qgd_tpu_torch against their plain PyTorch
versions, on the card. Marked ``cuda``; each test skips (inside the
``cuda`` fixture) where no GPU is present. This file imports no JAX, so
it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

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


SHAPES = [(3, 16, 4), (2, 130, 11), (4, 64, 8)]


@pytest.mark.parametrize("m", [1, 2, 3, 6])
@pytest.mark.parametrize("B,n,b", SHAPES)
def test_lhs_kernel_matches_plain(cuda, m, B, n, b):
    A, _ = _inputs(m, B, m, n, b, cuda)
    out = qt.ops.hermite_lhs_matrix_kernel_call(A, 0.05, m)
    torch.cuda.synchronize()
    assert _rel_err(out, sk.lhs_matrix_plain(A, 0.05, m)) <= REL_TOL


@pytest.mark.parametrize("m", [1, 2, 3, 6])
@pytest.mark.parametrize("B,n,b", SHAPES)
def test_rhs_kernel_matches_plain(cuda, m, B, n, b):
    A, W = _inputs(10 + m, B, m, n, b, cuda)
    out = qt.ops.hermite_rhs_kernel_call(A, W, 0.05, m)
    torch.cuda.synchronize()
    assert _rel_err(out, sk.rhs_plain(A, W, 0.05, m)) <= REL_TOL


def test_kernels_at_main_path_shape(cuda):
    """B = 256 scenarios, 2N = 128, m = 2, b = 8, at the CNOT3 step size."""
    A, W = _inputs(3, 256, 2, 128, 8, cuda, scale=1.0)
    dt = torch.tensor(0.55, dtype=torch.float32, device=cuda)
    assert _rel_err(qt.ops.hermite_lhs_matrix_kernel_call(A, dt, 2),
                    sk.lhs_matrix_plain(A, dt, 2)) <= REL_TOL
    assert _rel_err(qt.ops.hermite_rhs_kernel_call(A, W, dt, 2),
                    sk.rhs_plain(A, W, dt, 2)) <= REL_TOL


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


def test_kernels_refuse_what_they_do_not_take(cuda):
    A, W = _inputs(6, 2, 2, 16, 4, cuda)
    with pytest.raises(TypeError):
        qt.ops.hermite_lhs_matrix_kernel_call(A.double(), 0.1, 2)
    with pytest.raises(ValueError):
        qt.ops.hermite_lhs_matrix_kernel_call(
            A.transpose(-1, -2), 0.1, 2)
    with pytest.raises(ValueError):
        qt.ops.hermite_rhs_kernel_call(A, W.cpu(), 0.1, 2)
    with pytest.raises(ValueError):
        qt.ops.hermite_rhs_kernel_call(A, W.transpose(-1, -2), 0.1, 2)


def test_launch_counters_count_kernel_launches(cuda):
    A, W = _inputs(7, 2, 2, 16, 4, cuda)
    sk.reset_launch_counts()
    qt.ops.hermite_lhs_matrix_kernel_call(A, 0.1, 2)
    qt.ops.hermite_rhs_kernel_call(A, W, 0.1, 2)
    qt.ops.hermite_rhs_kernel_call(A, W, 0.1, 2)
    sk.lhs_matrix_plain(A, 0.1, 2)
    assert sk.launch_counts() == {"hermite_lhs_matrix": 1, "hermite_rhs": 2}


def test_slice_kernel_route_matches_plain_route(cuda):
    """CNOT3 at full width, 8 steps, 2 scenarios, f32: the kernel route
    against the plain route on the card, and both wrappers launched once
    per forward step."""
    prob = qt.cnot3_problem(tf=4.4, nsteps=8, solver="schulz",
                            dtype="float32", schulz_iters=48,
                            schulz_warm_budget=0, device=cuda)
    ctrls = tuple(qt.BSpline2Control(10, prob.tf) for _ in range(3))
    pcof = np.random.default_rng(0).standard_normal((2, 60)) * 0.01
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))
    sk.reset_launch_counts()
    (j1_k, g_k, _), grad_k = qt.segmented_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4)
    assert sk.launch_counts() == {"hermite_lhs_matrix": 8, "hermite_rhs": 8}
    (j1_p, g_p, _), grad_p = qt.segmented_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4, use_kernels=False)
    assert sk.launch_counts() == {"hermite_lhs_matrix": 8, "hermite_rhs": 8}
    assert float((j1_k - j1_p).abs().max()) <= 1e-5
    assert float((g_k - g_p).abs().max()) <= 1e-5
    assert float((grad_k - grad_p).norm() / grad_p.norm()) <= 1e-4
