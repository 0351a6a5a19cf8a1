"""The stage-recursion kernels of the Hermite step: hand-written CUDA for
Hopper (``csrc/lhs.cuh`` behind ``csrc/lhs.cu`` and ``csrc/pair.cu``,
``csrc/rhs.cu``), each with its plain PyTorch version, an
``autograd.Function`` and a launch counter.

* :func:`hermite_lhs_matrix_kernel_call` replaces the Pallas kernel
  ``qgd_tpu/ops/pallas_step.py:184`` (``hermite_lhs_matrix_kernel_call``):
  ``A_stack (B, m, n, n)``, scalar ``dt`` -> ``(B, n, n)`` one-step
  matrices ``sum_j (sign*dt)^j c_j D_j`` from the recursion on the
  identity: the implicit-stage matrix at ``sign = -1`` (the Pallas
  kernel's only sign), the explicit-side matrix at ``sign = +1``.
  At the main-path shape (B=256, n=128, m=2) it is one 128^3 FP32 product
  per matrix, bounded about equally by the FP32 FMA rate and by the bytes
  it must move; one launch per call stages each matrix whole in shared
  memory and writes the result once. Larger n, and the levels past the
  first of m >= 3, take one launch per level of 128-row output tiles fed
  through a ring of asynchronous copies.
* :func:`hermite_stage_pair_kernel_call`, the backward's pair ``(R, L)``
  of one-step matrices ``sum_j dt^j c_j D_j`` and ``sum_j (-dt)^j c_j
  D_j`` from one identity recursion: the counterpart of the JAX package's
  XLA function ``qgd_tpu/forward.py:158`` (``_stage_matrices_both``)
  (``hermite_stage_pair_f32``, ``csrc/pair.cu``). At m = 2 with n <= 128
  (the main path) one launch of ``csrc/pair_tf32.cuh`` does the product
  on the tensor cores in split TF32 (three TF32 passes that keep float32
  accuracy), 64 x 64 output tiles spread over blocks, and writes both
  sums: HBM bytes bound it. Other shapes take a variant of the LHS
  kernels that shares every product and writes both sums.
* :func:`hermite_rhs_kernel_call` replaces the Pallas kernel
  ``qgd_tpu/ops/pallas_step.py:91`` (``hermite_rhs_kernel_call``):
  ``A_stack (B, m, n, n)``, ``W (B, n, b)``, scalar ``dt`` -> ``(B, n, b)``
  ``sum_j (sign*dt)^j c_j W_j`` of the recursion on ``W``: the explicit
  half of a step at ``sign = +1`` (the Pallas kernel's only sign), the
  implicit stage applied to ``W`` at ``sign = -1`` (the GMRES operator).
  HBM-bound (2*b FLOP per element of the stack). For n <= 128 one launch
  per call requests the whole stack at once, stages ``A_0`` in shared
  memory, streams the rest from L2 and keeps the state levels in shared
  memory; larger n takes one launch per level, each element's rows spread
  over blocks, with the state levels in a scratch tensor allocated here.

The kernels compute the step scales ``(sign*dt)^(k+1)`` themselves (f32,
as ``qgd_tpu.ops.pallas_step._scaled_stack``) and multiply each stack
element by its scale once as it arrives: the same single f32 rounding as
a scaled copy, which is never written. ``dt`` on the card is read there in
place; a number goes by value. So a wrapper call launches the kernels and
nothing else (at m=2 one device kernel each).

Dispatch: a tensor on the CPU takes the plain version (that is the CPU
path and what the tests compare against the JAX package); a CUDA tensor
launches the kernel through the ``autograd.Function`` or raises (f32
only, contiguous, all operands on one device, a shape the kernels take).
There is no fallback. The backward of each Function is the VJP of the
plain version, as ``_lhs_kernel_call_bwd``/``_rhs_kernel_call_bwd`` are in
JAX; its forward-mode rule (``jvp``) is the tangent of the plain version,
the recursion differentiated level by level in the work dtype, beside the
primal the kernel launch gave (JAX has no tangent kernel either: off the
TPU its ``jacfwd`` runs the XLA definition).

Each wrapper counts its kernel launches in ``<wrapper>.launches``: one
per call that launches the kernel, added where it launches and nowhere
else; each also counts them by step sign (:func:`lhs_launches_by_sign`,
:func:`rhs_launches_by_sign`; the pair's recursion runs at sign +1).
Reset the counters
(:func:`reset_launch_counts`) just before the run they should
attribute.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .hermite import hermite_coefficients, scaled_derivatives, build_rhs, \
    build_lhs


def _stack_scales(dt, m: int, sign: float, device) -> torch.Tensor:
    """The ``m`` f32 step scales ``(sign*dt)^(k+1)`` that multiply ``A_k``
    (k = stack index): the plain version of what the kernels compute
    themselves (``step_scale`` in ``csrc/stage_common.cuh``), for the tests
    and the library yardstick of ``chip_smoke.py``."""
    s = torch.as_tensor(dt, dtype=torch.float32, device=device) * sign
    return s ** torch.arange(1, m + 1, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# plain versions (dtype-generic; the CPU path and the VJP definition)
# --------------------------------------------------------------------------

def lhs_matrix_plain(A_stack: torch.Tensor, dt, m: int,
                     sign: float = -1.0) -> torch.Tensor:
    """``(B, m, n, n)`` -> ``(B, n, n)``: ``sum_j (sign*dt)^j c_j D_j`` of
    the identity recursion, in ``A_stack.dtype``."""
    n = A_stack.shape[-1]
    eye = torch.eye(n, dtype=A_stack.dtype, device=A_stack.device)
    d = torch.as_tensor(dt, dtype=A_stack.dtype, device=A_stack.device)
    # build_lhs weighs D_j by (-d)^j
    return build_lhs(scaled_derivatives(A_stack, eye, m),
                     d if sign == -1.0 else -d, m)


def stage_pair_plain(A_stack: torch.Tensor, dt, m: int):
    """``(B, m, n, n)`` -> ``(R, L)``, each ``(B, n, n)``: ``sum_j dt^j
    c_j D_j`` and ``sum_j (-dt)^j c_j D_j`` of one identity recursion, in
    ``A_stack.dtype`` (the JAX package's ``_stage_matrices_both``)."""
    n = A_stack.shape[-1]
    eye = torch.eye(n, dtype=A_stack.dtype, device=A_stack.device)
    d = torch.as_tensor(dt, dtype=A_stack.dtype, device=A_stack.device)
    D = scaled_derivatives(A_stack, eye, m)
    return build_rhs(D, d, m), build_lhs(D, d, m)


def rhs_plain(A_stack: torch.Tensor, W: torch.Tensor, dt, m: int,
              sign: float = 1.0) -> torch.Tensor:
    """``(B, m, n, n)``, ``(B, n, b)`` -> ``(B, n, b)``: ``sum_j
    (sign*dt)^j c_j W_j`` of the recursion on ``W``, in ``W.dtype``."""
    d = torch.as_tensor(dt, dtype=W.dtype, device=W.device)
    return build_rhs(scaled_derivatives(A_stack, W, m),
                     d if sign == 1.0 else -d, m)


# --------------------------------------------------------------------------
# launches (CUDA f32 only)
# --------------------------------------------------------------------------

def _check_cuda_f32(name: str, t: torch.Tensor, device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the CUDA kernel, "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@lru_cache(maxsize=None)
def _coeffs_arg(m: int):
    """The m+1 Hermite weights as a C float array, built once per m."""
    return (ctypes.c_float * (m + 1))(*hermite_coefficients(m))


def _dt_args(dt, device: torch.device):
    """``(tensor or None, value)``: a scalar on the card is read by the
    kernel in place (as f32); a number or a CPU scalar goes by value."""
    if not isinstance(dt, torch.Tensor):
        return None, float(dt)
    if dt.numel() != 1:
        raise ValueError(f"dt must be a scalar, got shape {tuple(dt.shape)}")
    if dt.device.type == "cpu":
        return None, float(dt)
    if dt.device != device:
        raise ValueError(f"dt is on {dt.device}, expected {device}")
    return dt.to(torch.float32), 0.0


def _raise_on(err: int, what: str, shape: str):
    from .cuda_build import SHAPE_REFUSED

    if err == SHAPE_REFUSED:
        raise ValueError(f"{what}: no kernel takes {shape}")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _check_sign(sign: float) -> float:
    if sign not in (-1.0, 1.0):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    return float(sign)


def _launch_stage(A_stack: torch.Tensor, dt, m: int, sign: float,
                  pair: bool = False):
    """One launch of the LHS kernels: ``out`` at step sign ``sign``, or
    with ``pair`` the pair ``(R, L)`` (sign +1)."""
    from .cuda_build import load_library

    what = "hermite_stage_pair_f32" if pair else "hermite_lhs_matrix_f32"
    if A_stack.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors only")
    if A_stack.dim() != 4 or A_stack.shape[1] != m or \
            A_stack.shape[2] != A_stack.shape[3]:
        raise ValueError(f"A_stack must be (B, m={m}, n, n), got "
                         f"{tuple(A_stack.shape)}")
    _check_cuda_f32("A_stack", A_stack, A_stack.device)
    lib = load_library()
    B, _, n, _ = A_stack.shape
    dev = A_stack.device
    dt_t, dt_value = _dt_args(dt, dev)
    with torch.cuda.device(dev):
        scratch = (torch.empty((B, m - 2, n, n), dtype=torch.float32,
                               device=dev) if m >= 3 else None)
        outs = [torch.empty((B, n, n), dtype=torch.float32, device=dev)
                for _ in range(2 if pair else 1)]
        args = (A_stack.data_ptr(),
                None if dt_t is None else dt_t.data_ptr(), dt_value)
        tail = (_coeffs_arg(m), B, m, n,
                torch.cuda.current_stream(dev).cuda_stream)
        scratch_p = None if scratch is None else scratch.data_ptr()
        if pair:
            err = lib.hermite_stage_pair_f32(
                *args, scratch_p, outs[0].data_ptr(), outs[1].data_ptr(),
                *tail)
        else:
            err = lib.hermite_lhs_matrix_f32(*args, sign, scratch_p,
                                             outs[0].data_ptr(), *tail)
    _raise_on(err, what, f"B={B}, m={m}, n={n}")
    counter = (hermite_stage_pair_kernel_call if pair
               else hermite_lhs_matrix_kernel_call)
    counter.launches += 1
    counter.launches_by_sign[sign] += 1
    return tuple(outs) if pair else outs[0]


def _launch_rhs(A_stack: torch.Tensor, W: torch.Tensor, dt, m: int,
                sign: float = 1.0) -> torch.Tensor:
    from .cuda_build import load_library

    if A_stack.device.type != "cuda":
        raise ValueError("the RHS kernel takes CUDA tensors only")
    if A_stack.dim() != 4 or A_stack.shape[1] != m or \
            A_stack.shape[2] != A_stack.shape[3]:
        raise ValueError(f"A_stack must be (B, m={m}, n, n), got "
                         f"{tuple(A_stack.shape)}")
    B, _, n, _ = A_stack.shape
    if W.dim() != 3 or W.shape[0] != B or W.shape[1] != n:
        raise ValueError(f"W must be (B={B}, n={n}, b), got "
                         f"{tuple(W.shape)}")
    _check_cuda_f32("A_stack", A_stack, A_stack.device)
    _check_cuda_f32("W", W, A_stack.device)
    lib = load_library()
    b = W.shape[2]
    dev = A_stack.device
    dt_t, dt_value = _dt_args(dt, dev)
    with torch.cuda.device(dev):
        # the level path's state levels W_1 .. W_{m-1}; none on the
        # stream path (n <= 128), which keeps them in shared memory: the
        # kernel's own rule, which reads the stack's address only for its
        # 16-byte alignment
        floats = lib.hermite_rhs_scratch_floats(
            int(A_stack.data_ptr() % 16 == 0), B, m, n, b)
        scratch = (torch.empty(floats, dtype=torch.float32, device=dev)
                   if floats else None)
        out = torch.empty((B, n, b), dtype=torch.float32, device=dev)
        err = lib.hermite_rhs_f32(
            A_stack.data_ptr(), None if dt_t is None else dt_t.data_ptr(),
            dt_value, sign, W.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            _coeffs_arg(m), B, m, n, b,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hermite_rhs_f32", f"B={B}, m={m}, n={n}, b={b}")
    hermite_rhs_kernel_call.launches += 1
    hermite_rhs_kernel_call.launches_by_sign[sign] += 1
    return out


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------

def _save_dt(ctx, dt):
    """Keep ``dt`` (tensor or number) for the backward."""
    ctx.dt_value = None if isinstance(dt, torch.Tensor) else dt
    return dt if isinstance(dt, torch.Tensor) else None


def _dt_input(ctx, dt_t, index: int):
    """``dt`` for the plain VJP: a leaf needing grad when the caller's
    ``dt`` does, else its value."""
    if dt_t is None:
        return ctx.dt_value, False
    want = ctx.needs_input_grad[index]
    return dt_t.detach().requires_grad_(want), want


def _plus(acc, x):
    return x if acc is None else acc + x


def _derivatives_with_tangents(A, A_t, W0, W0_t, m: int):
    """The scaled derivatives ``W_0 .. W_m`` of the recursion on ``W0``
    (:func:`~.hermite.scaled_derivatives`, the same order of sums) and
    their tangents along ``A_t`` and ``W0_t``, the recursion differentiated
    level by level::

        W'_{j+1} = 1/(j+1) sum_{i<=j} (A'_{j-i} W_i + A_{j-i} W'_i)

    Two lists of ``m + 1`` tensors; a tangent that is zero (``A_t`` and
    ``W0_t`` may be ``None``) is ``None``."""
    Ws, Ts = [W0], [W0_t]
    for j in range(m):
        acc = tan = None
        for i in range(j + 1):
            acc = _plus(acc, A[..., j - i, :, :] @ Ws[i])
            if A_t is not None:
                tan = _plus(tan, A_t[..., j - i, :, :] @ Ws[i])
            if Ts[i] is not None:
                tan = _plus(tan, A[..., j - i, :, :] @ Ts[i])
        Ws.append(acc / (j + 1))
        Ts.append(None if tan is None else tan / (j + 1))
    return Ws, Ts


def _weighted_tangent(Ws, Ts, s, s_t, m: int):
    """Tangent of ``sum_j s^j c_j W_j`` from :func:`_derivatives_with_tangents`
    (``s``: the signed step, a number or 0-d tensor; ``s_t``: its tangent
    or ``None``): ``sum_j c_j (s^j W'_j + j s^(j-1) s' W_j)``."""
    c = hermite_coefficients(m)
    out = Ts[0]                             # c_0 = 1
    for j in range(1, m + 1):
        if Ts[j] is not None:
            out = _plus(out, (c[j] * s ** j) * Ts[j])
        if s_t is not None:
            out = _plus(out, (c[j] * j * s ** (j - 1) * s_t) * Ws[j])
    return out


def _step_with_tangent(ctx, dt_t, dt_tan, like: torch.Tensor, sign: float):
    """``(sign*dt, its tangent or None)`` in ``like``'s dtype: a tensor
    ``dt`` carries the caller's tangent, a number none."""
    d = torch.as_tensor(ctx.dt_value if dt_t is None else dt_t,
                        dtype=like.dtype, device=like.device)
    s_t = None if dt_tan is None else sign * dt_tan.to(like.dtype)
    return sign * d, s_t


def _identity_recursion(A, A_t, m: int):
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return _derivatives_with_tangents(A, A_t, eye, None, m)


class HermiteLHSMatrix(torch.autograd.Function):
    """Kernel forward on CUDA (plain forward on the CPU); backward is the
    VJP of :func:`lhs_matrix_plain`, forward mode its tangent."""

    @staticmethod
    def forward(ctx, A_stack, dt, m, sign):
        ctx.m, ctx.sign = m, sign
        dt_t = _save_dt(ctx, dt)
        ctx.save_for_backward(A_stack, dt_t)
        ctx.save_for_forward(A_stack, dt_t)
        if A_stack.device.type == "cuda":
            return _launch_stage(A_stack, dt, m, sign)
        return lhs_matrix_plain(A_stack, dt, m, sign)

    @staticmethod
    def backward(ctx, g):
        A_stack, dt_t = ctx.saved_tensors
        with torch.enable_grad():
            a = A_stack.detach().requires_grad_(True)
            d, want_dt = _dt_input(ctx, dt_t, 1)
            inputs = [a, d] if want_dt else [a]
            out = lhs_matrix_plain(a, d, ctx.m, ctx.sign)
            grads = torch.autograd.grad(out, inputs, g.to(out.dtype))
        ddt = grads[1].to(dt_t.dtype) if want_dt else None
        return grads[0].to(A_stack.dtype), ddt, None, None

    @staticmethod
    def jvp(ctx, A_tan, dt_tan, *_):
        A_stack, dt_t = ctx.saved_tensors
        s, s_t = _step_with_tangent(ctx, dt_t, dt_tan, A_stack, ctx.sign)
        Ws, Ts = _identity_recursion(A_stack, A_tan, ctx.m)
        return _weighted_tangent(Ws, Ts, s, s_t, ctx.m)


class HermiteStagePair(torch.autograd.Function):
    """Pair-kernel forward on CUDA (plain forward on the CPU); backward
    is the VJP of :func:`stage_pair_plain`, forward mode its tangents."""

    @staticmethod
    def forward(ctx, A_stack, dt, m):
        ctx.m = m
        dt_t = _save_dt(ctx, dt)
        ctx.save_for_backward(A_stack, dt_t)
        ctx.save_for_forward(A_stack, dt_t)
        if A_stack.device.type == "cuda":
            return _launch_stage(A_stack, dt, m, 1.0, pair=True)
        return stage_pair_plain(A_stack, dt, m)

    @staticmethod
    def backward(ctx, g_r, g_l):
        A_stack, dt_t = ctx.saved_tensors
        with torch.enable_grad():
            a = A_stack.detach().requires_grad_(True)
            d, want_dt = _dt_input(ctx, dt_t, 1)
            inputs = [a, d] if want_dt else [a]
            R, L = stage_pair_plain(a, d, ctx.m)
            grads = torch.autograd.grad((R, L), inputs,
                                        (g_r.to(R.dtype), g_l.to(L.dtype)))
        ddt = grads[1].to(dt_t.dtype) if want_dt else None
        return grads[0].to(A_stack.dtype), ddt, None

    @staticmethod
    def jvp(ctx, A_tan, dt_tan, _):
        A_stack, dt_t = ctx.saved_tensors
        d, d_t = _step_with_tangent(ctx, dt_t, dt_tan, A_stack, 1.0)
        Ws, Ts = _identity_recursion(A_stack, A_tan, ctx.m)
        # R at step +dt, L at -dt, from one recursion
        return (_weighted_tangent(Ws, Ts, d, d_t, ctx.m),
                _weighted_tangent(Ws, Ts, -d, None if d_t is None else -d_t,
                                  ctx.m))


class HermiteRHS(torch.autograd.Function):
    """Kernel forward on CUDA (plain forward on the CPU); backward is the
    VJP of :func:`rhs_plain`, forward mode its tangent."""

    @staticmethod
    def forward(ctx, A_stack, W, dt, m, sign=1.0):
        ctx.m, ctx.sign = m, sign
        dt_t = _save_dt(ctx, dt)
        ctx.save_for_backward(A_stack, W, dt_t)
        ctx.save_for_forward(A_stack, W, dt_t)
        if A_stack.device.type == "cuda":
            return _launch_rhs(A_stack, W, dt, m, sign)
        return rhs_plain(A_stack, W, dt, m, sign)

    @staticmethod
    def backward(ctx, g):
        A_stack, W, dt_t = ctx.saved_tensors
        with torch.enable_grad():
            a = A_stack.detach().requires_grad_(True)
            w = W.detach().requires_grad_(True)
            d, want_dt = _dt_input(ctx, dt_t, 2)
            inputs = [a, w, d] if want_dt else [a, w]
            out = rhs_plain(a, w, d, ctx.m, ctx.sign)
            grads = torch.autograd.grad(out, inputs, g.to(out.dtype))
        ddt = grads[2].to(dt_t.dtype) if want_dt else None
        return (grads[0].to(A_stack.dtype), grads[1].to(W.dtype), ddt, None,
                None)

    @staticmethod
    def jvp(ctx, A_tan, W_tan, dt_tan, *_):
        A_stack, W, dt_t = ctx.saved_tensors
        s, s_t = _step_with_tangent(ctx, dt_t, dt_tan, W, ctx.sign)
        Ws, Ts = _derivatives_with_tangents(A_stack, A_tan, W, W_tan, ctx.m)
        return _weighted_tangent(Ws, Ts, s, s_t, ctx.m)


# --------------------------------------------------------------------------
# public wrappers
# --------------------------------------------------------------------------

def hermite_lhs_matrix_kernel_call(A_stack: torch.Tensor, dt, m: int,
                                   sign: float = -1.0) -> torch.Tensor:
    """``A_stack (B, m, n, n)``, scalar ``dt`` -> ``(B, n, n)`` one-step
    matrices ``sum_j (sign*dt)^j c_j D_j`` (sign -1: the LHS matrices, +1:
    the explicit side). CPU: plain version. CUDA: the kernel."""
    sign = _check_sign(sign)
    if A_stack.device.type == "cpu":
        return lhs_matrix_plain(A_stack, dt, m, sign)
    return HermiteLHSMatrix.apply(A_stack, dt, m, sign)


def hermite_stage_pair_kernel_call(A_stack: torch.Tensor, dt, m: int):
    """``A_stack (B, m, n, n)``, scalar ``dt`` -> ``(R, L)``, each ``(B, n,
    n)``: ``sum_j dt^j c_j D_j`` and ``sum_j (-dt)^j c_j D_j`` of one
    identity recursion. CPU: plain version. CUDA: the pair kernel (one
    counted launch per call; at m >= 3 one more device launch per level
    j >= 2)."""
    if A_stack.device.type == "cpu":
        return stage_pair_plain(A_stack, dt, m)
    return HermiteStagePair.apply(A_stack, dt, m)


def hermite_rhs_kernel_call(A_stack: torch.Tensor, W: torch.Tensor, dt,
                            m: int, sign: float = 1.0) -> torch.Tensor:
    """``A_stack (B, m, n, n)``, ``W (B, n, b)``, scalar ``dt`` ->
    ``(B, n, b)`` ``sum_j (sign*dt)^j c_j W_j`` (sign +1: the explicit
    half, -1: the implicit stage applied to ``W``). CPU: plain version.
    CUDA: the kernel."""
    sign = _check_sign(sign)
    if A_stack.device.type == "cpu":
        return rhs_plain(A_stack, W, dt, m, sign)
    return HermiteRHS.apply(A_stack, W, dt, m, sign)


def hermite_rhs_kernel_launch(A_stack: torch.Tensor, W: torch.Tensor, dt,
                              m: int, sign: float = 1.0) -> torch.Tensor:
    """:func:`hermite_rhs_kernel_call` without its ``autograd.Function``,
    for callers that record no gradient through the result (the Arnoldi
    steps of the GMRES stage solve): the kernel on CUDA tensors, counted
    as every launch is; the plain version on the CPU."""
    sign = _check_sign(sign)
    if A_stack.device.type == "cpu":
        return rhs_plain(A_stack, W, dt, m, sign)
    return _launch_rhs(A_stack, W, dt, m, sign)


_WRAPPERS = {"hermite_lhs_matrix": hermite_lhs_matrix_kernel_call,
             "hermite_rhs": hermite_rhs_kernel_call,
             "hermite_stage_pair": hermite_stage_pair_kernel_call}


def reset_launch_counts():
    """Set every wrapper's launch counters to 0."""
    for name, f in _WRAPPERS.items():
        f.launches = 0
        # the pair's recursion runs at step sign +1 only
        f.launches_by_sign = ({1.0: 0} if name == "hermite_stage_pair"
                              else {-1.0: 0, 1.0: 0})


reset_launch_counts()


def launch_tally() -> dict:
    """Every counter by step sign: ``{(kernel, sign): n}``."""
    return {(name, sign): n for name, f in _WRAPPERS.items()
            for sign, n in f.launches_by_sign.items()}


def add_launches(tally: dict, times: int = 1):
    """Add ``times`` x ``tally`` (a :func:`launch_tally` difference) to the
    counters: a CUDA graph's replay launches the kernels its capture
    recorded without calling the wrappers, and the capture launches none
    of those its wrappers counted (``chunked._SegmentPrograms``)."""
    for (name, sign), n in tally.items():
        f = _WRAPPERS[name]
        f.launches += n * times
        f.launches_by_sign[sign] += n * times


def launch_counts() -> dict:
    """``{"hermite_lhs_matrix": n, "hermite_rhs": n, "hermite_stage_pair":
    n}``."""
    return {name: f.launches for name, f in _WRAPPERS.items()}


def lhs_launches_by_sign() -> dict:
    """LHS-kernel launches by step sign: ``{"-1": n, "+1": n}``."""
    by = hermite_lhs_matrix_kernel_call.launches_by_sign
    return {"-1": by[-1.0], "+1": by[1.0]}


def rhs_launches_by_sign() -> dict:
    """RHS-kernel launches by step sign: ``{"-1": n, "+1": n}`` (+1: the
    explicit halves, -1: GMRES operator applications)."""
    by = hermite_rhs_kernel_call.launches_by_sign
    return {"-1": by[-1.0], "+1": by[1.0]}
