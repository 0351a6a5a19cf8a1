"""``device.peak_mem_GiB`` (GiB): ``torch.cuda.max_memory_allocated()``
over the timed calls, its peak statistics reset at the window's start."""


def read(ctx):
    peak = ctx["peak_mem_bytes"]
    return peak / 2 ** 30 if peak else None
