"""``route.backward.device_ns_per_step`` (ns/step): device time of the
operations launched inside ``qgd.replay.bwd`` spans (the backward step
programs' graph replays; at L >= 2 the re-forward runs inside them) over
the traced calls' counted steps. Attributed as
``route.forward.device_ns_per_step`` is."""

from qgdbench import spans


def read(ctx):
    return spans.device_ns_per_step(ctx, lambda span: span == spans.REPLAY_BWD)
