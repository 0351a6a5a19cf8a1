"""``route.eager_idle_share`` (fraction): the device's idle time while the
host is outside every ``qgd.replay.*`` span, over the traced window. The
idle gaps are those between ``busy_intervals`` of the device operations,
as ``device.idle_share`` takes them; a gap whose midpoint falls inside a
replay span is the programs' (a graph launch the device waits for), every
other gap and the window's two ends (a draw before the first operation, a
synchronisation after the last) the eager code's. So ``device.idle_share``
minus this metric is the idle time inside program launches."""

from qgdbench import profiling, spans


def read(ctx):
    if ctx["busy_s"] <= 0 or spans.of(ctx) is None:
        return None
    busy = profiling.busy_intervals(ctx["device_ops"])
    idle = ctx["window_s"] - ctx["busy_s"]
    return (idle - spans.replay_idle_s(busy, ctx["spans"])) / ctx["window_s"]
