"""Device time by span (``qgdbench/spans.py``) on a synthetic trace: each
device operation goes to the innermost ``qgd.*`` span around the host
call that launched it (matched by correlation id), not to the span its
run overlaps; the readers of the segmented route find the trace in the
harness's frame and read nothing without spans."""

from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT

from qgdbench import harness, profiling, spans

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    """The methods of a profiler event that the split reads."""

    def __init__(self, name, start, end, device, kind, corr=0):
        self._v = (name, start, end, device, kind, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def activity_type(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[4] in ("user_annotation", "gpu_user_annotation")


def host(name, start, end, kind="cpu_op", corr=0):
    return Event(name, start, end, CPU, kind, corr)


def launch(name, at, corr):
    return Event(name, at, at + 5, CPU, "cuda_runtime", corr)


def kernel(name, start, end, corr, kind="kernel"):
    return Event(name, start, end, CUDA, kind, corr)


EVENTS = [
    host("qgd.call", 0, 3000),
    host("qgd.backward", 100, 2900),
    host("qgd.replay.bwd", 200, 300),
    host("qgd.replay.bwd", 1000, 1200),
    launch("cudaGraphLaunch", 250, 7),
    # a graph's kernels carry their launch's id and run after the span
    kernel("gemm", 400, 500, 7),
    kernel("lhs_staged_kernel", 500, 600, 7),
    launch("cudaLaunchKernel", 350, 8),
    kernel("add", 620, 650, 8),
    launch("cudaMemcpyAsync", 360, 11),
    kernel("Memcpy DtoD", 900, 1000, 11, kind="gpu_memcpy"),
    launch("cudaGraphLaunch", 1100, 10),
    kernel("gemm", 1300, 1400, 10),
    launch("cudaLaunchKernel", 3500, 9),                   # outside spans
    kernel("uniform", 3600, 3700, 9),
    kernel("orphan", 3800, 3900, 99),                      # no launch
    # an operator's own id may equal a launch's: not a launch
    host("aten::add", 5000, 5100, corr=7),
    # the device-timeline mirror of a user-scope range
    kernel("qgd.replay.bwd", 400, 600, 7, kind="gpu_user_annotation"),
]
SPAN_OF = {(400, 7): "qgd.replay.bwd", (500, 7): "qgd.replay.bwd",
           (620, 8): "qgd.backward", (900, 11): "qgd.backward",
           (1300, 10): "qgd.replay.bwd", (3600, 9): "", (3800, 99): None}


def test_each_operation_goes_to_the_span_of_its_launch():
    parts = spans.split(EVENTS)
    got = {(s, n): span for (_, s, _, span), n in
           zip(parts["device"], [7, 7, 8, 11, 10, 9, 99])}
    assert got == SPAN_OF
    assert [name for name, _, _, _ in parts["device"]] == [
        "gemm", "lhs_staged_kernel", "add", "Memcpy DtoD", "gemm",
        "uniform", "orphan"]
    assert [s[0] for s in parts["spans"]] == [
        "qgd.call", "qgd.backward", "qgd.replay.bwd", "qgd.replay.bwd"]


def test_device_annotation_ranges_leave_the_device_list():
    names = [d[0] for d in spans.split(EVENTS)["device"]]
    assert "qgd.replay.bwd" not in names
    assert len(names) == 7


def test_innermost_of_nested_spans():
    nest = [("a", 0, 100), ("b", 10, 50), ("c", 20, 30), ("d", 60, 70)]
    assert spans.innermost(nest, [5, 15, 25, 40, 55, 65, 100, 101]) == [
        "a", "b", "c", "b", "a", "d", "a", ""]


def _tracer(events):
    """A ``profiling.Tracer`` whose profiler recorded ``events``."""
    tracer = profiling.Tracer.__new__(profiling.Tracer)
    tracer._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return tracer


def test_reduce_keys_unchanged():
    """The harness's own reduction of the same trace: its keys and
    ``(name, start, end)`` tuples, whatever the spans add."""
    tt = _tracer(EVENTS).reduce()
    assert set(tt) == {"device", "host"}
    assert all(len(item) == 3 for item in tt["device"] + tt["host"])
    assert len(tt["device"]) == 8 and len(tt["host"]) == 10


def _ctx(steps_per_call=1):
    device = [(n, s, e) for n, s, e, _ in spans.split(EVENTS)["device"]]
    busy = profiling.busy_intervals(device)
    return {"device_ops": device, "window_s": 10_000e-9,
            "busy_s": sum(e - s for s, e in busy) / 1e9, "calls": 1,
            "nsteps": steps_per_call, "batch": 1}


def _read(metric, ctx, events):
    """``metric``'s reader called as the harness calls it: from a frame
    that holds ``ctx`` and the run's ``tracer``, where the reader finds
    the trace."""
    tracer = _tracer(events)  # noqa: F841 (read through this frame)
    return harness.load_reader(ROOT, metric)(ctx)


@pytest.mark.parametrize("metric,value", [
    ("route.forward.device_ns_per_step", None),
    ("route.backward.device_ns_per_step", 150.0),       # 300 ns, 2 steps
    ("route.eager.device_ns_per_step", 115.0),          # 230 ns
    # idle 9370 ns of 10000; 300 of it (1000..1300) inside a replay span
    ("route.eager_idle_share", 0.907),
])
def test_route_readers(metric, value):
    got = _read(metric, _ctx(), EVENTS)
    assert got == pytest.approx(value) if value is not None else got is None


@pytest.mark.parametrize("metric", [
    "route.forward.device_ns_per_step", "route.backward.device_ns_per_step",
    "route.eager.device_ns_per_step", "route.eager_idle_share"])
def test_route_readers_read_nothing_without_spans(metric):
    no_spans = [e for e in EVENTS if not e.name().startswith("qgd.")]
    assert _read(metric, _ctx(), no_spans) is None
    assert harness.load_reader(ROOT, metric)({"busy_s": 0.0}) is None
