"""Plain versions and autograd Functions of the qgd_tpu_torch stage
kernels against the Pallas kernels of qgd_tpu (interpret mode, f32, the
tolerance of tests/test_pallas.py) and against the JAX Hermite definition
in f64; the pair build against ``qgd_tpu.forward._stage_matrices_both``
(f64 at 1e-13, f32 against JAX's f64 at 1e-5 relative). The CUDA kernels
themselves are checked on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

from functools import lru_cache

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
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


def _pair_matches_jax_stage_matrices_both():
    """``stage_pair_plain`` and the port's ``_stage_matrices_both`` (the
    kernel route, which takes the plain version on the CPU, and the plain
    route; f64 and f32) against the JAX package's ``_stage_matrices_both``
    in f64, at m = 1..4, on a qubit in the rotating frame at 2N = 8 and at
    the ragged 2N = 10, control tables from a seed."""
    import dataclasses

    import qgd_tpu
    import qgd_tpu_torch as qt
    from qgd_tpu.forward import _stage_matrices_both as j_both
    from qgd_tpu_torch.forward import _stage_matrices_both as t_both

    rng = np.random.default_rng(40)
    for ess in (2, 3):                       # 2N = 8, 10
        jprob = qgd_tpu.rotating_frame_qubit(ess, 2, tf=1.0, nsteps=8)
        tprob = qt.rotating_frame_qubit(ess, 2, tf=1.0, nsteps=8,
                                        device="cpu")
        for m in (1, 2, 3, 4):
            P = rng.standard_normal((3, m, tprob.N_operators)) * 0.3
            Q = rng.standard_normal((3, m, tprob.N_operators)) * 0.3
            # one compile of the vmapped build rather than op by op
            R_j, L_j = (np.asarray(x) for x in jax.jit(
                lambda p_, q_: j_both(jprob, m, 0.55, p_, q_))(
                    jnp.asarray(P), jnp.asarray(Q)))
            for dtype, tol in ((torch.float64, 1e-13),
                               (torch.float32, 1e-5)):
                wprob = qt.working_problem(dataclasses.replace(
                    tprob, dtype=str(dtype).split(".")[1]))
                Pt = torch.tensor(P, dtype=dtype)
                Qt = torch.tensor(Q, dtype=dtype)
                dt = torch.tensor(0.55, dtype=dtype)
                A = qt.assemble_generator_stack(wprob, Pt, Qt, m)
                outs = [sk.stage_pair_plain(A, dt, m)]
                outs += [t_both(wprob, m, dt, Pt, Qt, use_kernels=u)
                         for u in (True, False)]
                for R, L in outs:
                    assert R.dtype == L.dtype == dtype
                    for x, ref in ((R, R_j), (L, L_j)):
                        err = np.abs(x.double().numpy() - ref).max()
                        assert err <= tol * np.abs(ref).max(), (ess, m,
                                                                dtype, err)


def _tf32(x, nearest=True):
    """float32 -> TF32 (10 mantissa bits) by mantissa rounding, to nearest
    with ties away from zero or toward zero, as the pair kernel cuts its
    operands' hi and lo parts."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    if nearest:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32_pair_matches_f64():
    """The pair kernel's arithmetic at m = 2, emulated in float32: the
    scaled At_0 split into hi = tf32(x) (to nearest) and lo = x - hi (cut
    toward zero), the product as hi·hi + hi·lo + lo·hi, then the kernel's
    epilogue. On CNOT3 stacks
    at the main path's dt (4 seeded scenarios, step 500 of 1000) it holds
    to the float64 ``stage_pair_plain`` within 1e-6 of max |ref|, the card
    check's bound; one TF32 pass (hi·hi) misses it."""
    import qgd_tpu_torch as qt
    from qgd_tpu_torch.forward import _time_grid

    prob = qt.cnot3_problem(nsteps=1000, solver="schulz", dtype="float32",
                            schulz_warm_budget=0, device="cpu")
    ctrls = tuple(qt.BSpline2Control(10, prob.tf) for _ in range(3))
    pcof = torch.tensor(
        np.random.default_rng(0).standard_normal((4, 60)) * 0.01)
    _, ts = _time_grid(prob)
    P, Q = qt.control_tables(ctrls, pcof, ts[500:501], 2)
    A = qt.assemble_generator_stack(qt.working_problem(prob),
                                    P[:, 0].float(), Q[:, 0].float(),
                                    2).numpy()
    s = np.float32(prob.tf / prob.nsteps)
    c = [np.float32(x) for x in qt.hermite_coefficients(2)]
    a0, a1 = A[:, 0] * s, A[:, 1] * (s * s)
    hi = _tf32(a0)
    lo = _tf32(a0 - hi, nearest=False)
    eye = np.eye(A.shape[-1], dtype=np.float32) * c[0]
    refs = [x.numpy() for x in sk.stage_pair_plain(
        torch.tensor(A, dtype=torch.float64), float(s), 2)]

    def err(prod):
        d2 = (a1 + prod) / np.float32(2)
        pair = ((eye + c[1] * a0) + c[2] * d2, (eye - c[1] * a0) + c[2] * d2)
        return max(np.abs(x - ref).max() / np.abs(ref).max()
                   for x, ref in zip(pair, refs))

    assert err(lo @ hi + hi @ lo + hi @ hi) <= 1e-6
    assert err(hi @ hi) > 1e-5


@pytest.mark.parametrize("m", [1, 2, 3, 6])
def test_plain_versions_match_hermite_definition_f64(m):
    if m == 1:
        _pair_matches_jax_stage_matrices_both()
    if m == 2:
        _split_tf32_pair_matches_f64()
    A, W = _inputs(2, 3, m, 16, 4, dtype=np.float64)
    dt = 0.37
    lhs = sk.lhs_matrix_plain(torch.tensor(A), dt, m).numpy()
    # sign +1: the explicit-side matrices sum_j dt^j c_j D_j
    lhs_plus = sk.hermite_lhs_matrix_kernel_call(torch.tensor(A), dt, m,
                                                 sign=1.0).numpy()
    rhs = sk.rhs_plain(torch.tensor(A), torch.tensor(W), dt, m).numpy()
    for k in range(3):
        D = scaled_derivatives(jnp.asarray(A[k]), jnp.eye(16), m)
        Ws = scaled_derivatives(jnp.asarray(A[k]), jnp.asarray(W[k]), m)
        np.testing.assert_allclose(lhs[k], np.asarray(build_lhs(D, dt, m)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(lhs_plus[k],
                                   np.asarray(build_rhs(D, dt, m)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(rhs[k], np.asarray(build_rhs(Ws, dt, m)),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fn", ["lhs", "rhs"])
def test_autograd_functions_gradcheck_f64(fn):
    """Each Function's backward and forward-mode rule by gradcheck, and
    its tangent against ``jax.jvp`` of the JAX package's definition."""
    A, W = _inputs(3, 2, 2, 5, 3, dtype=np.float64)
    a = torch.tensor(A, requires_grad=True)
    w = torch.tensor(W, requires_grad=True)
    d = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)

    def check(f, inputs):
        assert torch.autograd.gradcheck(f, inputs, check_forward_ad=True)

    if fn == "lhs":
        check(lambda a_, d_: sk.HermiteLHSMatrix.apply(a_, d_, 2, -1.0),
              (a, d))
        check(lambda a_: sk.HermiteLHSMatrix.apply(a_, 0.3, 2, 1.0), (a,))
        # the pair's Function: both outputs, dt a tensor or a number
        check(lambda a_, d_: sk.HermiteStagePair.apply(a_, d_, 2), (a, d))
        check(lambda a_: sk.HermiteStagePair.apply(a_, 0.3, 3),
              (torch.tensor(_inputs(6, 2, 3, 5, 3, dtype=np.float64)[0],
                            requires_grad=True),))
    else:
        check(lambda a_, w_, d_: sk.HermiteRHS.apply(a_, w_, d_, 2),
              (a, w, d))
        check(lambda a_, w_: sk.HermiteRHS.apply(a_, w_, 0.3, 2), (a, w))
    _tangents_match_jax_jvp(fn)


JVP_DT, JVP_DT_TANGENT = 0.37, -0.8


def _jvp_inputs(m):
    """``(A, W, A tangent, W tangent)``, float64, B = 2, n = 6, b = 3."""
    return (*_inputs(10 + m, 2, m, 6, 3, dtype=np.float64),
            *_inputs(20 + m, 2, m, 6, 3, dtype=np.float64))


@lru_cache(maxsize=None)
def _jax_tangents(m):
    """``jax.jvp`` in float64 of JAX's sides for each stack of
    :func:`_jvp_inputs`: (L, R) of the identity recursion (sign -1 and
    +1) and R of the recursion on W, along the tangents of A, W and dt."""
    A, W, At, Wt = _jvp_inputs(m)

    def sides(A_, W_, dt_):
        def one(a_, w_):
            D = scaled_derivatives(a_, jnp.eye(a_.shape[-1]), m)
            return (build_lhs(D, dt_, m), build_rhs(D, dt_, m),
                    build_rhs(scaled_derivatives(a_, w_, m), dt_, m))
        return jax.vmap(one)(A_, W_)

    tangents = jax.jit(lambda p, t: jax.jvp(sides, p, t)[1])(
        (jnp.asarray(A), jnp.asarray(W), jnp.float64(JVP_DT)),
        (jnp.asarray(At), jnp.asarray(Wt), jnp.float64(JVP_DT_TANGENT)))
    return tuple(np.asarray(t) for t in tangents)


def _tangents_match_jax_jvp(fn):
    """The tangents of the Functions (``.apply`` under forward-mode AD,
    f64) along A, W and a tensor dt against ``jax.jvp`` of
    ``build_lhs``/``build_rhs`` of ``scaled_derivatives`` in float64, at
    m = 2 and 3."""
    import torch.autograd.forward_ad as fwAD

    f64 = torch.float64
    for m in (2, 3):
        A, W, At, Wt = _jvp_inputs(m)
        lhs_ref, rhs_ref, w_ref = _jax_tangents(m)
        with fwAD.dual_level():
            a = fwAD.make_dual(torch.tensor(A), torch.tensor(At))
            w = fwAD.make_dual(torch.tensor(W), torch.tensor(Wt))
            d = fwAD.make_dual(torch.tensor(JVP_DT, dtype=f64),
                               torch.tensor(JVP_DT_TANGENT, dtype=f64))
            if fn == "lhs":
                pairs = [(sk.HermiteLHSMatrix.apply(a, d, m, -1.0), lhs_ref),
                         (sk.HermiteLHSMatrix.apply(a, d, m, 1.0), rhs_ref),
                         *zip(sk.HermiteStagePair.apply(a, d, m),
                              (rhs_ref, lhs_ref))]
            else:
                pairs = [(sk.HermiteRHS.apply(a, w, d, m), w_ref)]
            for out, ref in pairs:
                tan = fwAD.unpack_dual(out).tangent.numpy()
                assert np.abs(tan - ref).max() <= 1e-12 * np.abs(ref).max()


def test_cpu_tensors_take_plain_version_and_launch_nothing():
    A, W = _inputs(4, 2, 2, 16, 4)
    sk.reset_launch_counts()
    a, w = torch.tensor(A), torch.tensor(W)
    assert torch.equal(sk.hermite_lhs_matrix_kernel_call(a, 0.1, 2),
                       sk.lhs_matrix_plain(a, 0.1, 2))
    assert torch.equal(sk.hermite_rhs_kernel_call(a, w, 0.1, 2),
                       sk.rhs_plain(a, w, 0.1, 2))
    assert torch.equal(sk.hermite_lhs_matrix_kernel_call(a, 0.1, 2, 1.0),
                       sk.lhs_matrix_plain(a, 0.1, 2, 1.0))
    for x, y in zip(sk.hermite_stage_pair_kernel_call(a, 0.1, 2),
                    sk.stage_pair_plain(a, 0.1, 2)):
        assert torch.equal(x, y)
    assert sk.launch_counts() == {"hermite_lhs_matrix": 0, "hermite_rhs": 0,
                                  "hermite_stage_pair": 0}
    assert sk.lhs_launches_by_sign() == {"-1": 0, "+1": 0}
    with pytest.raises(ValueError):
        sk.hermite_lhs_matrix_kernel_call(a, 0.1, 2, 0.5)
    for pair in (False, True):
        with pytest.raises(ValueError):
            sk._launch_stage(a, 0.1, 2, -1.0, pair)
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


def test_dt_reaches_the_kernels_by_value_or_in_place():
    """A number or a CPU scalar goes to the kernels by value; a tensor with
    more than one element is refused."""
    cpu = torch.device("cpu")
    assert sk._dt_args(0.55, cpu) == (None, 0.55)
    assert sk._dt_args(np.float32(0.25), cpu) == (None, 0.25)
    assert sk._dt_args(torch.tensor(0.5, dtype=torch.float64), cpu) == \
        (None, 0.5)
    with pytest.raises(ValueError):
        sk._dt_args(torch.ones(2), cpu)
