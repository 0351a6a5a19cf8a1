"""Device time by the port's spans (``qgd_tpu_torch/tracing.py``): each
device operation of a traced run is put down to the innermost ``qgd.*``
span that was open on the host when the operation was launched.

An operation's launch is the CUDA API call with the same correlation id
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunchKernel``, ...); the
kernels a graph replay runs carry the correlation id of their
``cudaGraphLaunch``. The launch's start on the host is placed among the
spans. Time overlap between an operation and a span is not used: the
host runs ahead of the device, so a kernel often runs while the host is
already in a later span.

The per-layer readers of the segmented route take the split from the
traced run's profiler, found in the frame of the harness that calls
them (its ``tracer``, beside the ``ctx`` it passes), and keep it in
``ctx`` for one another: ``ctx["span_ops"]``, one ``(name, start_ns,
end_ns, span)`` per device operation, ``span`` the innermost ``qgd.*``
span of its launch, ``""`` for a launch outside every span and ``None``
where no launch was found; ``ctx["spans"]``, the ``qgd.*`` host spans,
``(name, start_ns, end_ns)`` sorted by start.
"""

from __future__ import annotations

import bisect
import sys

from qgdbench.harness import COUNTED_PASSES

SPAN_PREFIX = "qgd."
REPLAY_FWD = "qgd.replay.fwd"
REPLAY_BWD = "qgd.replay.bwd"
REPLAYS = (REPLAY_FWD, REPLAY_BWD)


def split(events) -> dict:
    """``{"device": [(name, start_ns, end_ns, span)], "spans": [(name,
    start_ns, end_ns)]}`` from a profiler's ``kineto_results.events()``
    (or objects with the same methods), each sorted by start (module
    docstring). Device-timeline annotation ranges (``gpu_user_annotation``,
    the mirror of a user-scope host range) are left out of ``device``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, spans, launch_at = [], [], {}
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                start = e.start_ns()
                device.append((name, start, start + e.duration_ns(),
                               e.correlation_id()))
        elif is_launch(name):
            launch_at[e.correlation_id()] = e.start_ns()
        elif name.startswith(SPAN_PREFIX):
            start = e.start_ns()
            spans.append((name, start, start + e.duration_ns()))
    device.sort(key=lambda x: x[1])
    spans.sort(key=lambda x: x[1])
    launches = sorted(set(launch_at.values()))
    inner = dict(zip(launches, innermost(spans, launches)))
    out = []
    for name, s, e, corr in device:
        t = launch_at.get(corr)
        out.append((name, s, e, None if t is None else inner[t]))
    return {"device": out, "spans": spans}


def is_launch(name: str) -> bool:
    """A CUDA API call (``cuda...``, or ``cu`` and a capital), whose
    correlation id is the one CUPTI gives the device work it launched; an
    operator's own id (``aten::...``) may equal such an id and is not
    one."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def innermost(spans, times) -> list:
    """For each of the sorted ``times``, the name of the innermost of the
    nested ``spans`` (sorted by start) open at it, ``""`` where none is."""
    names, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        names.append(stack[-1][0] if stack else "")
    return names


def _traced_events(ctx):
    """The events of the profiler whose trace ``ctx`` was made from: the
    ``tracer`` of the frame that holds this ``ctx``; ``None`` if there is
    none."""
    frame = sys._getframe(1)
    while frame is not None:
        f_locals = frame.f_locals
        if f_locals.get("ctx") is ctx and "tracer" in f_locals:
            prof = getattr(f_locals["tracer"], "_prof", None)
            results = getattr(getattr(prof, "profiler", None),
                              "kineto_results", None)
            return None if results is None else results.events()
        frame = frame.f_back
    return None


def of(ctx):
    """``ctx`` with ``"span_ops"`` and ``"spans"`` (module docstring),
    the split made once per traced run; ``None`` where no trace is found
    or it holds no ``qgd.*`` span."""
    if "span_ops" not in ctx:
        events = _traced_events(ctx)
        parts = split(events) if events is not None else {"device": [],
                                                          "spans": []}
        ctx["span_ops"], ctx["spans"] = parts["device"], parts["spans"]
    return ctx if ctx["spans"] else None


def counted_steps(ctx) -> int:
    """The traced calls' counted Hermite steps, as the harness counts
    them."""
    return COUNTED_PASSES * ctx["nsteps"] * ctx["batch"] * ctx["calls"]


def device_ns_per_step(ctx, keep):
    """Device ns per counted step of the operations whose launch span
    ``keep(span)`` accepts (found launches only); ``None`` where none."""
    if of(ctx) is None:
        return None
    ns = sum(e - s for _, s, e, span in ctx["span_ops"]
             if span is not None and keep(span))
    return ns / counted_steps(ctx) if ns > 0 else None


def replay_idle_s(busy, spans) -> float:
    """Seconds of the device's idle gaps between the ``busy`` intervals
    whose midpoint falls inside a replay span of ``spans``."""
    replays = [(s, e) for name, s, e in spans if name in REPLAYS]
    starts = [s for s, _ in replays]
    idle = 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 <= e0:
            continue
        mid = (e0 + s1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and replays[i][1] >= mid:
            idle += s1 - e0
    return idle / 1e9
