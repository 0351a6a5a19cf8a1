"""The two stage-recursion kernels of the Hermite step: hand-written CUDA
for Hopper (``csrc/lhs.cu``, ``csrc/rhs.cu``), each with its plain PyTorch
version, an ``autograd.Function`` and a launch counter.

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
JAX.

Each wrapper counts its kernel launches in ``<wrapper>.launches``: one
per call that launches the kernel, added where it launches and nowhere
else; each also counts them by step sign (:func:`lhs_launches_by_sign`,
:func:`rhs_launches_by_sign`). Reset the counters
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


def _launch_lhs(A_stack: torch.Tensor, dt, m: int,
                sign: float) -> torch.Tensor:
    from .cuda_build import load_library

    if A_stack.device.type != "cuda":
        raise ValueError("the LHS kernel takes CUDA tensors only")
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
        out = torch.empty((B, n, n), dtype=torch.float32, device=dev)
        err = lib.hermite_lhs_matrix_f32(
            A_stack.data_ptr(), None if dt_t is None else dt_t.data_ptr(),
            dt_value, sign, None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), _coeffs_arg(m), B, m, n,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hermite_lhs_matrix_f32", f"B={B}, m={m}, n={n}")
    hermite_lhs_matrix_kernel_call.launches += 1
    hermite_lhs_matrix_kernel_call.launches_by_sign[sign] += 1
    return out


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


def _no_forward_rule(*_):
    raise NotImplementedError(
        "forward-mode AD reached a CUDA stage kernel, which has no forward "
        "rule (as JAX's custom_vjp refuses jacfwd): run forward-mode checks "
        "(eval_grad_forced, eval_hessian(method='ad')) on a float64 problem")


class HermiteLHSMatrix(torch.autograd.Function):
    """Kernel forward on CUDA (plain forward on the CPU); backward is the
    VJP of :func:`lhs_matrix_plain`; no forward-mode rule."""

    jvp = staticmethod(_no_forward_rule)

    @staticmethod
    def forward(ctx, A_stack, dt, m, sign):
        ctx.m, ctx.sign = m, sign
        ctx.save_for_backward(A_stack, _save_dt(ctx, dt))
        if A_stack.device.type == "cuda":
            return _launch_lhs(A_stack, dt, m, sign)
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


class HermiteRHS(torch.autograd.Function):
    """Kernel forward on CUDA (plain forward on the CPU); backward is the
    VJP of :func:`rhs_plain`; no forward-mode rule."""

    jvp = staticmethod(_no_forward_rule)

    @staticmethod
    def forward(ctx, A_stack, W, dt, m, sign=1.0):
        ctx.m, ctx.sign = m, sign
        ctx.save_for_backward(A_stack, W, _save_dt(ctx, dt))
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


def reset_launch_counts():
    """Set both wrappers' launch counters to 0."""
    hermite_lhs_matrix_kernel_call.launches = 0
    hermite_lhs_matrix_kernel_call.launches_by_sign = {-1.0: 0, 1.0: 0}
    hermite_rhs_kernel_call.launches = 0
    hermite_rhs_kernel_call.launches_by_sign = {-1.0: 0, 1.0: 0}


reset_launch_counts()


def launch_counts() -> dict:
    """``{"hermite_lhs_matrix": n, "hermite_rhs": n}``."""
    return {"hermite_lhs_matrix": hermite_lhs_matrix_kernel_call.launches,
            "hermite_rhs": hermite_rhs_kernel_call.launches}


def lhs_launches_by_sign() -> dict:
    """LHS-kernel launches by step sign: ``{"-1": n, "+1": n}``."""
    by = hermite_lhs_matrix_kernel_call.launches_by_sign
    return {"-1": by[-1.0], "+1": by[1.0]}


def rhs_launches_by_sign() -> dict:
    """RHS-kernel launches by step sign: ``{"-1": n, "+1": n}`` (+1: the
    explicit halves, -1: GMRES operator applications)."""
    by = hermite_rhs_kernel_call.launches_by_sign
    return {"-1": by[-1.0], "+1": by[1.0]}
