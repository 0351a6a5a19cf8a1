"""qgd_tpu_torch Newton-Schulz inverses and refinement stage solves
against qgd_tpu.ops.linalg, float64."""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from qgd_tpu.ops import linalg as jl  # noqa: E402
from qgd_tpu_torch.ops import linalg as tl  # noqa: E402

torch.set_num_threads(1)


def _stage_like(seed, S, n, eps=0.1):
    """Near-identity matrices, like Hermite stage matrices."""
    rng = np.random.default_rng(seed)
    return np.eye(n) + eps * rng.standard_normal((S, n, n)) / np.sqrt(n)


def test_schulz_inverse_auto_cold_matches_jax():
    M = _stage_like(0, 3, 12)
    ours = tl.schulz_inverse_auto(torch.tensor(M), 30, dtype=torch.float64)
    ref = jl.schulz_inverse_auto(jnp.asarray(M), 30, dtype=jnp.float64)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(ours.numpy() @ M, np.broadcast_to(
        np.eye(12), M.shape), atol=1e-12)


@pytest.mark.parametrize("warm", [0, 3])
def test_schulz_guard_falls_back_per_matrix_like_jax(warm):
    """X0 is a good warm start for matrix 0 and a diverging one
    (||I - M X0|| >= 1) for matrix 1: the guard swaps in the universal init
    for matrix 1 only."""
    M = _stage_like(1, 2, 10, eps=0.05)
    X0 = np.linalg.inv(M[0])
    M[1] = 3.0 * M[1]
    ours = tl.schulz_inverse_auto(torch.tensor(M), 48, dtype=torch.float64,
                                  X0=torch.tensor(X0), warm_iters=warm)
    ref = jl.schulz_inverse_auto(jnp.asarray(M), 48, dtype=jnp.float64,
                                 X0=jnp.asarray(X0), warm_iters=warm)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-14)
    univ = tl.schulz_inverse(torch.tensor(M[1:]), tl.schulz_universal_init(
        torch.tensor(M[1:])), warm)
    np.testing.assert_array_equal(ours[1:].numpy(), univ.numpy())
    if warm == 0:
        np.testing.assert_array_equal(ours[0].numpy(), X0)


def test_schulz_warm_iters_rule():
    for total in (8, 48, 56, 100):
        assert tl.schulz_warm_iters(total) == jl.schulz_warm_iters(total)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("sweeps", [None, 2])
def test_inverse_stage_solve_matches_jax(transpose, sweeps):
    """Forward solve, and the transposed solve that JAX's
    custom_linear_solve uses for the adjoint (reached here through a
    VJP)."""
    M = _stage_like(2, 3, 12)
    # an f32 approximate inverse, as the stage solves use
    X = np.linalg.inv(M).astype(np.float32) + np.float32(1e-3)
    rng = np.random.default_rng(3)
    B = rng.standard_normal((3, 12, 4))
    ours = tl.inverse_stage_solve(torch.tensor(M), torch.tensor(X),
                                  torch.tensor(B), sweeps,
                                  transpose=transpose).numpy()
    solve = lambda b: jl.inverse_stage_solve(jnp.asarray(M), jnp.asarray(X),
                                             b, sweeps)
    if transpose:
        _, vjp = jax.vjp(solve, jnp.zeros_like(jnp.asarray(B)))
        (ref,) = vjp(jnp.asarray(B))
    else:
        ref = solve(jnp.asarray(B))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    MT = np.swapaxes(M, -1, -2) if transpose else M
    resid = np.abs(MT @ ours - B).max()
    assert resid < (1e-4 if sweeps == 2 else 1e-8)


def test_f32_sweep_default_is_three():
    assert tl.REFINE_SWEEPS_F32 == 3
