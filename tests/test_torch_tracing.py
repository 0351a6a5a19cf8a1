"""The segmented route's spans (``qgd_tpu_torch.tracing``): off without a
profiler, nested as documented under one, and without effect on the
answers. A Rabi problem of a few steps and two control vectors on the
CPU, where every program run is eager and carries its replay span."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import qgd_tpu_torch as qt
from qgd_tpu_torch import segmented as seg
from qgd_tpu_torch import tracing

NSTEPS, S = 4, 2
RUNS = 2                 # program runs a pass: two blocks, or two segments
PHASES = ["qgd.tables", "qgd.forward", "qgd.terminal", "qgd.backward",
          "qgd.table_vjp"]


def _setup():
    prob = qt.construct_rabi_prob(nsteps=NSTEPS, device="cpu")
    controls = qt.GRAPEControl(1, prob.tf)
    pcof = np.random.default_rng(3).standard_normal((S, 2)) * 0.3
    target = np.array([[0, 1], [1, 0]], dtype=complex)
    return prob, controls, pcof, target


def _spans(prof):
    """The ``qgd.*`` host ranges of a trace, ``(name, start, end)`` by
    start (outer before inner on a tie)."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("qgd.")]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_one_shared_null_context_without_a_profiler():
    a, b = tracing.span("qgd.call"), tracing.span("qgd.replay.fwd")
    assert a is b is tracing._OFF
    with a:
        pass


@pytest.mark.parametrize("n_segments,block", [
    (NSTEPS, 2),             # L = 1: two blocks of 2 steps
    (NSTEPS // 2, None),     # L = 2: two segments
])
def test_spans_nest_and_leave_answers_unchanged(monkeypatch, n_segments,
                                                block):
    if block is not None:
        monkeypatch.setattr(seg, "_BLOCK_STEPS", block)
    prob, controls, pcof, target = _setup()

    def call():
        return qt.segmented_objective_and_gradient(
            prob, controls, pcof, target, 4, ridge_penalty_strength=1e-3,
            n_segments=n_segments)

    (j_off, g_off, r_off), grad_off = call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (j_on, g_on, r_on), grad_on = call()
        value = qt.segmented_objective_value(
            prob, controls, pcof, target, 4, ridge_penalty_strength=1e-3,
            n_segments=n_segments)
    for off, on in ((j_off, j_on), (g_off, g_on), (r_off, r_on),
                    (grad_off, grad_on)):
        assert torch.equal(off, on)
    assert torch.equal(value, j_off + g_off + r_off)

    spans = _spans(prof)
    calls = [s for s in spans if s[0] == "qgd.call"]
    assert len(calls) == 2
    grad_call, value_call = calls
    within = lambda outer: [s for s in spans
                            if s is not outer and _inside(s, outer)]
    phases = [s for s in within(grad_call) if s[0] in PHASES]
    assert [s[0] for s in phases] == PHASES          # in order, once each
    by_name = dict((s[0], s) for s in phases)
    for kind, phase in (("fwd", "qgd.forward"), ("bwd", "qgd.backward")):
        replays = [s for s in within(grad_call)
                   if s[0] == "qgd.replay." + kind]
        assert len(replays) == RUNS
        assert all(_inside(r, by_name[phase]) for r in replays)
    assert ([s[0] for s in within(value_call) if s[0] in PHASES]
            == PHASES[:3])
    assert sum(s[0] == "qgd.replay.fwd" for s in within(value_call)) == RUNS
    assert not any(s[0] == "qgd.replay.bwd" for s in within(value_call))
    assert len(spans) == 2 + len(PHASES) + 3 + 3 * RUNS
