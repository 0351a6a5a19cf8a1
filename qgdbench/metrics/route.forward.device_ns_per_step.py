"""``route.forward.device_ns_per_step`` (ns/step): device time of the
operations launched inside ``qgd.replay.fwd`` spans (the forward step
programs' graph replays) over the traced calls' counted steps, ``2 *
nsteps * batch * calls``. Attributed by the launch's correlation id
(``qgdbench/spans.py``); a program without the span reads nothing."""

from qgdbench import spans


def read(ctx):
    return spans.device_ns_per_step(ctx, lambda span: span == spans.REPLAY_FWD)
