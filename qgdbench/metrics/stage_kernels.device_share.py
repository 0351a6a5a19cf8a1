"""``stage_kernels.device_share`` (fraction): the device time of the stage
kernels (``qgdbench.profiling.STAGE_KERNEL_NAMES``) over the device time
of every operation traced (kernels, copies, fills)."""

from qgdbench.profiling import stage_seconds


def read(ctx):
    stage = stage_seconds(ctx["device_ops"])
    total = sum(e - s for _, s, e in ctx["device_ops"]) / 1e9
    return stage / total if stage > 0 else None
