"""Plain versions and autograd Functions of the qgd_tpu_torch stage
kernels against the Pallas kernels of qgd_tpu (interpret mode, f32, the
tolerance of tests/test_pallas.py) and against the JAX Hermite definition
in f64. The CUDA kernels themselves are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from qgd_tpu.ops.hermite import (scaled_derivatives,  # noqa: E402
                                 build_rhs, build_lhs)
from qgd_tpu.ops.pallas_step import (hermite_rhs_kernel_call,  # noqa: E402
                                     hermite_lhs_matrix_kernel_call)
from qgd_tpu_torch.ops import stage_kernels as sk  # noqa: E402

torch.set_num_threads(1)


def _inputs(seed, B, m, n, b, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, m, n, n)) * 0.3).astype(dtype)
    W = rng.standard_normal((B, n, b)).astype(dtype)
    return A, W


@pytest.mark.parametrize("m", [1, 2, 3, 6])
def test_rhs_plain_matches_pallas_interpret(m):
    A, W = _inputs(0, 3, m, 16, 4)
    ref = np.asarray(hermite_rhs_kernel_call(jnp.asarray(A), jnp.asarray(W),
                                             0.05, m, interpret=True))
    out = sk.hermite_rhs_kernel_call(torch.tensor(A), torch.tensor(W), 0.05,
                                     m)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("m", [1, 2, 3, 6])
def test_lhs_plain_matches_pallas_interpret(m):
    A, _ = _inputs(1, 2, m, 16, 4)
    ref = np.asarray(hermite_lhs_matrix_kernel_call(jnp.asarray(A), 0.05, m,
                                                    interpret=True))
    out = sk.hermite_lhs_matrix_kernel_call(torch.tensor(A), 0.05, m)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("m", [1, 2, 3, 6])
def test_plain_versions_match_hermite_definition_f64(m):
    A, W = _inputs(2, 3, m, 16, 4, dtype=np.float64)
    dt = 0.37
    lhs = sk.lhs_matrix_plain(torch.tensor(A), dt, m).numpy()
    rhs = sk.rhs_plain(torch.tensor(A), torch.tensor(W), dt, m).numpy()
    for k in range(3):
        D = scaled_derivatives(jnp.asarray(A[k]), jnp.eye(16), m)
        Ws = scaled_derivatives(jnp.asarray(A[k]), jnp.asarray(W[k]), m)
        np.testing.assert_allclose(lhs[k], np.asarray(build_lhs(D, dt, m)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(rhs[k], np.asarray(build_rhs(Ws, dt, m)),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fn", ["lhs", "rhs"])
def test_autograd_functions_gradcheck_f64(fn):
    A, W = _inputs(3, 2, 2, 5, 3, dtype=np.float64)
    a = torch.tensor(A, requires_grad=True)
    w = torch.tensor(W, requires_grad=True)
    d = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    if fn == "lhs":
        assert torch.autograd.gradcheck(
            lambda a_, d_: sk.HermiteLHSMatrix.apply(a_, d_, 2), (a, d))
        assert torch.autograd.gradcheck(
            lambda a_: sk.HermiteLHSMatrix.apply(a_, 0.3, 2), (a,))
    else:
        assert torch.autograd.gradcheck(
            lambda a_, w_, d_: sk.HermiteRHS.apply(a_, w_, d_, 2),
            (a, w, d))
        assert torch.autograd.gradcheck(
            lambda a_, w_: sk.HermiteRHS.apply(a_, w_, 0.3, 2), (a, w))


def test_cpu_tensors_take_plain_version_and_launch_nothing():
    A, W = _inputs(4, 2, 2, 16, 4)
    sk.reset_launch_counts()
    a, w = torch.tensor(A), torch.tensor(W)
    assert torch.equal(sk.hermite_lhs_matrix_kernel_call(a, 0.1, 2),
                       sk.lhs_matrix_plain(a, 0.1, 2))
    assert torch.equal(sk.hermite_rhs_kernel_call(a, w, 0.1, 2),
                       sk.rhs_plain(a, w, 0.1, 2))
    assert sk.launch_counts() == {"hermite_lhs_matrix": 0, "hermite_rhs": 0}
    with pytest.raises(ValueError):
        sk._launch_lhs(a, 0.1, 2)
    with pytest.raises(ValueError):
        sk._launch_rhs(a, w, 0.1, 2)


def test_stack_scales_match_jax_prescale():
    """The kernels scale the stack with the f32 arithmetic of JAX's
    ``_scaled_stack``."""
    from qgd_tpu.ops.pallas_step import _scaled_stack

    A, _ = _inputs(5, 2, 3, 8, 2)
    for sign in (1.0, -1.0):
        scales = sk._stack_scales(np.float32(0.55), 3, sign, "cpu")
        ours = torch.tensor(A) * scales[:, None, None]
        ref = np.asarray(_scaled_stack(jnp.asarray(A), 0.55, 3, sign))
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-7, atol=0)
