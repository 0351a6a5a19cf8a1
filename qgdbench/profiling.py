"""The device trace of a traced run: ``torch.profiler`` (CPU and CUDA
activities; CUPTI sees the kernels inside CUDA graph replays) around whole
calls, reduced in memory to device intervals, host intervals and the
sums the per-layer readers and the ``breakdown`` take. Nothing is
written to disk."""

from __future__ import annotations

import bisect

# an idle gap shorter than this sits between two device operations of one
# stream of work (graph nodes, back-to-back launches) and is summed apart
SHORT_GAP_NS = 20_000
_HOST_SCAN = 4000


class Tracer:
    """``start()`` before the traced calls, ``stop()`` after them (the
    device synchronised); ``reduce()`` once the window has closed."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def start(self):
        self._prof.__enter__()

    def stop(self):
        self._prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        """``{"device": [(name, start_ns, end_ns)], "host": [...]}``, each
        sorted by start."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            item = (e.name(), start, start + e.duration_ns())
            (device if e.device_type() == cuda else host).append(item)
        device.sort(key=lambda x: x[1])
        host.sort(key=lambda x: x[1])
        return {"device": device, "host": host}


# the hand-written stage kernels of ``qgd_tpu_torch/csrc``, by name (at
# m >= 3 the backward's pair runs as an ``lhs_`` kernel)
STAGE_KERNEL_NAMES = ("lhs_", "stage_pair", "rhs_")


def stage_seconds(device) -> float:
    """Device seconds of the stage kernels among ``device``'s operations."""
    return sum(e - s for name, s, e in device
               if any(k in name for k in STAGE_KERNEL_NAMES)) / 1e9


def is_kernel(name: str) -> bool:
    """A device kernel, not a copy or a fill."""
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def busy_intervals(device) -> list:
    """The union of the device intervals, ``[(start_ns, end_ns)]``."""
    merged = []
    for _, s, e in device:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def top_device_ops(device, k: int = 10) -> list:
    """``[[name, seconds]]`` of the ``k`` device operations (by name) that
    took most time."""
    by_name = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:160], ns / 1e9] for name, ns in top]


def idle_gaps(busy, host, k: int = 10) -> list:
    """``[[what, seconds]]``: the device's idle time between its busy
    intervals, gaps under ``SHORT_GAP_NS`` summed under one name and the
    longer ones by the innermost host operation running at their middle,
    the ``k`` largest sums."""
    starts = [h[1] for h in host]
    sums = {}
    short = "idle gaps under %d us (between device ops)" % (
        SHORT_GAP_NS // 1000)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        if gap < SHORT_GAP_NS:
            key = short
        else:
            mid = (e0 + s1) // 2
            key = "host: none"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - _HOST_SCAN, -1), -1):
                if host[j][2] >= mid:
                    key = "host: " + host[j][0][:120]
                    break
        sums[key] = sums.get(key, 0) + gap
    top = sorted(sums.items(), key=lambda kv: -kv[1])[:k]
    return [[name, ns / 1e9] for name, ns in top]
