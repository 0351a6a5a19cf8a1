"""``linalg.gemm_share`` (fraction): the device time of cuBLAS's matrix
products over the device time of every operation traced. Attributed by
kernel name (``gemm`` or ``gemv`` in it, in any case): the Schulz guard's
and the refinement sweeps' products of ``ops/linalg`` and the other
cuBLAS products of the step (the adjoint's ``R^T lam``, the guard's
projector) alike."""


def read(ctx):
    ops = ctx["device_ops"]
    total = sum(e - s for _, s, e in ops)
    gemm = sum(e - s for name, s, e in ops
               if "gemm" in name.lower() or "gemv" in name.lower())
    return gemm / total if gemm > 0 else None
