"""The two stage-recursion kernels of the Hermite step: hand-written CUDA
for Hopper (``csrc/hermite_stage.cu``), each with its plain PyTorch
version, an ``autograd.Function`` and a launch counter.

* :func:`hermite_lhs_matrix_kernel_call` replaces the Pallas kernel
  ``qgd_tpu/ops/pallas_step.py:184`` (``hermite_lhs_matrix_kernel_call``):
  ``A_stack (B, m, n, n)``, scalar ``dt`` -> ``(B, n, n)`` implicit-stage
  matrices ``sum_j (-dt)^j c_j D_j`` from the recursion on the identity.
  On the card it is FP32-FMA-bound (256 x 2*128^3 FLOP per call at the
  main-path shape B=256, n=128, m=2 against ~48 MB moved); the kernel
  computes 64x64 output tiles from shared-memory-staged operands with 4x4
  register micro-tiles per thread and never multiplies by the identity.
* :func:`hermite_rhs_kernel_call` replaces the Pallas kernel
  ``qgd_tpu/ops/pallas_step.py:91`` (``hermite_rhs_kernel_call``):
  ``A_stack (B, m, n, n)``, ``W (B, n, b)``, scalar ``dt`` -> ``(B, n, b)``
  explicit half ``sum_j dt^j c_j W_j``. Bandwidth-bound (~32 MB of A per
  call at the main shape, 2*b FLOP per element read); the kernel keeps
  every state level in shared memory, so only A travels, staged through
  shared-memory tiles read coalesced with many loads in flight, one
  output row per thread.

Both wrappers compute the step scales ``(sign*dt)^(k+1)`` with the f32
arithmetic of ``qgd_tpu.ops.pallas_step._scaled_stack``; the kernels
multiply each stack element by its scale as they read it (the same single
f32 rounding as a scaled copy, which is never written), so they need only
the constant Hermite weights besides.

Dispatch: a tensor on the CPU takes the plain version (that is the CPU
path and what the tests compare against the JAX package); a CUDA tensor
launches the kernel through the ``autograd.Function`` or raises (f32
only, contiguous, all operands on one device). There is no fallback.
The backward of each Function is the VJP of the plain version, as
``_lhs_kernel_call_bwd``/``_rhs_kernel_call_bwd`` are in JAX.

Each wrapper counts its kernel launches in ``<wrapper>.launches``: one
per call that launches the kernel, added where it launches and nowhere
else. Reset the counters (:func:`reset_launch_counts`) just before the
run they should attribute.
"""

from __future__ import annotations

import ctypes

import torch

from .hermite import hermite_coefficients, scaled_derivatives, build_rhs, \
    build_lhs

# Shared memory a block may use on Hopper (bytes).
_MAX_SHARED_BYTES = 232448


def _stack_scales(dt, m: int, sign: float, device) -> torch.Tensor:
    """The ``m`` f32 step scales ``(sign*dt)^(k+1)`` that multiply ``A_k``
    (k = stack index). ``dt`` on the device keeps this free of
    host-to-device copies."""
    s = torch.as_tensor(dt, dtype=torch.float32, device=device) * sign
    return s ** torch.arange(1, m + 1, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# plain versions (dtype-generic; the CPU path and the VJP definition)
# --------------------------------------------------------------------------

def lhs_matrix_plain(A_stack: torch.Tensor, dt, m: int) -> torch.Tensor:
    """``(B, m, n, n)`` -> ``(B, n, n)``: ``sum_j (-dt)^j c_j D_j`` of the
    identity recursion, in ``A_stack.dtype``."""
    n = A_stack.shape[-1]
    eye = torch.eye(n, dtype=A_stack.dtype, device=A_stack.device)
    return build_lhs(scaled_derivatives(A_stack, eye, m),
                     torch.as_tensor(dt, dtype=A_stack.dtype,
                                     device=A_stack.device), m)


def rhs_plain(A_stack: torch.Tensor, W: torch.Tensor, dt,
              m: int) -> torch.Tensor:
    """``(B, m, n, n)``, ``(B, n, b)`` -> ``(B, n, b)``: ``sum_j dt^j c_j
    W_j`` of the recursion on ``W``, in ``W.dtype``."""
    return build_rhs(scaled_derivatives(A_stack, W, m),
                     torch.as_tensor(dt, dtype=W.dtype, device=W.device), m)


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


def _check_levels(lib, m: int):
    if not 1 <= m <= lib.hermite_stage_max_levels():
        raise ValueError(f"m={m} outside the kernel's range "
                         f"1..{lib.hermite_stage_max_levels()}")


def _coeffs_arg(m: int):
    return (ctypes.c_float * (m + 1))(*hermite_coefficients(m))


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _launch_lhs(A_stack: torch.Tensor, dt, m: int) -> torch.Tensor:
    from .cuda_build import load_library

    if A_stack.device.type != "cuda":
        raise ValueError("the LHS kernel takes CUDA tensors only")
    if A_stack.dim() != 4 or A_stack.shape[1] != m or \
            A_stack.shape[2] != A_stack.shape[3]:
        raise ValueError(f"A_stack must be (B, m={m}, n, n), got "
                         f"{tuple(A_stack.shape)}")
    _check_cuda_f32("A_stack", A_stack, A_stack.device)
    lib = load_library()
    _check_levels(lib, m)
    B, _, n, _ = A_stack.shape
    dev = A_stack.device
    with torch.cuda.device(dev):
        scales = _stack_scales(dt, m, -1.0, dev)
        scratch = torch.empty((B, max(m - 2, 0), n, n), dtype=torch.float32,
                              device=dev)
        out = torch.empty((B, n, n), dtype=torch.float32, device=dev)
        err = lib.hermite_lhs_matrix_f32(
            A_stack.data_ptr(), scales.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), _coeffs_arg(m),
            B, m, n, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hermite_lhs_matrix_f32")
    hermite_lhs_matrix_kernel_call.launches += 1
    return out


def _launch_rhs(A_stack: torch.Tensor, W: torch.Tensor, dt,
                m: int) -> torch.Tensor:
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
    _check_levels(lib, m)
    b = W.shape[2]
    # the kernel's shared memory: its ring of four 128 x 33 At tiles, plus
    # the state levels zero-padded to (32-row, 8-column) multiples
    smem = 4 * (4 * 128 * 33 + (m + 1) * -(-n // 32) * 32 * -(-b // 8) * 8)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"the RHS kernel needs {smem} B of shared memory "
                         f"(> {_MAX_SHARED_BYTES}); n={n}, b={b}, m={m}")
    dev = A_stack.device
    with torch.cuda.device(dev):
        scales = _stack_scales(dt, m, 1.0, dev)
        out = torch.empty((B, n, b), dtype=torch.float32, device=dev)
        err = lib.hermite_rhs_f32(
            A_stack.data_ptr(), scales.data_ptr(), W.data_ptr(),
            out.data_ptr(), _coeffs_arg(m),
            B, m, n, b, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hermite_rhs_f32")
    hermite_rhs_kernel_call.launches += 1
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


class HermiteLHSMatrix(torch.autograd.Function):
    """Kernel forward on CUDA (plain forward on the CPU); backward is the
    VJP of :func:`lhs_matrix_plain`."""

    @staticmethod
    def forward(ctx, A_stack, dt, m):
        ctx.m = m
        ctx.save_for_backward(A_stack, _save_dt(ctx, dt))
        if A_stack.device.type == "cuda":
            return _launch_lhs(A_stack, dt, m)
        return lhs_matrix_plain(A_stack, dt, m)

    @staticmethod
    def backward(ctx, g):
        A_stack, dt_t = ctx.saved_tensors
        with torch.enable_grad():
            a = A_stack.detach().requires_grad_(True)
            d, want_dt = _dt_input(ctx, dt_t, 1)
            inputs = [a, d] if want_dt else [a]
            out = lhs_matrix_plain(a, d, ctx.m)
            grads = torch.autograd.grad(out, inputs, g.to(out.dtype))
        ddt = grads[1].to(dt_t.dtype) if want_dt else None
        return grads[0].to(A_stack.dtype), ddt, None


class HermiteRHS(torch.autograd.Function):
    """Kernel forward on CUDA (plain forward on the CPU); backward is the
    VJP of :func:`rhs_plain`."""

    @staticmethod
    def forward(ctx, A_stack, W, dt, m):
        ctx.m = m
        ctx.save_for_backward(A_stack, W, _save_dt(ctx, dt))
        if A_stack.device.type == "cuda":
            return _launch_rhs(A_stack, W, dt, m)
        return rhs_plain(A_stack, W, dt, m)

    @staticmethod
    def backward(ctx, g):
        A_stack, W, dt_t = ctx.saved_tensors
        with torch.enable_grad():
            a = A_stack.detach().requires_grad_(True)
            w = W.detach().requires_grad_(True)
            d, want_dt = _dt_input(ctx, dt_t, 2)
            inputs = [a, w, d] if want_dt else [a, w]
            out = rhs_plain(a, w, d, ctx.m)
            grads = torch.autograd.grad(out, inputs, g.to(out.dtype))
        ddt = grads[2].to(dt_t.dtype) if want_dt else None
        return grads[0].to(A_stack.dtype), grads[1].to(W.dtype), ddt, None


# --------------------------------------------------------------------------
# public wrappers
# --------------------------------------------------------------------------

def hermite_lhs_matrix_kernel_call(A_stack: torch.Tensor, dt,
                                   m: int) -> torch.Tensor:
    """``A_stack (B, m, n, n)``, scalar ``dt`` -> ``(B, n, n)`` LHS matrices
    ``sum_j (-dt)^j c_j D_j``. CPU: plain version. CUDA: the kernel."""
    if A_stack.device.type == "cpu":
        return lhs_matrix_plain(A_stack, dt, m)
    return HermiteLHSMatrix.apply(A_stack, dt, m)


def hermite_rhs_kernel_call(A_stack: torch.Tensor, W: torch.Tensor, dt,
                            m: int) -> torch.Tensor:
    """``A_stack (B, m, n, n)``, ``W (B, n, b)``, scalar ``dt`` ->
    ``(B, n, b)`` explicit half ``sum_j dt^j c_j W_j``. CPU: plain
    version. CUDA: the kernel."""
    if A_stack.device.type == "cpu":
        return rhs_plain(A_stack, W, dt, m)
    return HermiteRHS.apply(A_stack, W, dt, m)


hermite_lhs_matrix_kernel_call.launches = 0
hermite_rhs_kernel_call.launches = 0


def reset_launch_counts():
    """Set both wrappers' launch counters to 0."""
    hermite_lhs_matrix_kernel_call.launches = 0
    hermite_rhs_kernel_call.launches = 0


def launch_counts() -> dict:
    """``{"hermite_lhs_matrix": n, "hermite_rhs": n}``."""
    return {"hermite_lhs_matrix": hermite_lhs_matrix_kernel_call.launches,
            "hermite_rhs": hermite_rhs_kernel_call.launches}
