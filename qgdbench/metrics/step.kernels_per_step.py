"""``step.kernels_per_step`` (kernels/step): device kernels launched in
the traced calls (copies and fills not counted) over the calls' time
steps, ``calls * nsteps``. A count: it repeats exactly, so a fusion
shows in it."""

from qgdbench.profiling import is_kernel


def read(ctx):
    n = sum(1 for name, _, _ in ctx["device_ops"] if is_kernel(name))
    return n / (ctx["calls"] * ctx["nsteps"]) if n else None
