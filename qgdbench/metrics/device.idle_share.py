"""``device.idle_share`` (fraction): 1 - (the union of the device's
operation intervals) / (the traced window on the host's clock, whole
calls each ended by a synchronisation)."""


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    return 1.0 - ctx["busy_s"] / ctx["window_s"]
