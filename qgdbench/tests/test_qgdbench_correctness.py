"""``correct`` fails where it should: the control (the reference in TF32
put in the program's place, :class:`qgdbench.calibrate.Control`) and the
faults a run of these cells can have, each planted under a whole run of
the harness on the CPU (the look for a card skipped) at a size a test run
holds. The exchange between chips is
not among them: every cell runs on one chip."""

import numpy as np
import pytest
import torch

from conftest import TINY, make_root

from qgdbench import harness
from qgdbench.calibrate import Control
from qgdbench.program import Program


def _run(root, factory, seconds=0.2):
    spec = harness.load_cell(root, "tiny.small")
    result, checks = harness.run_cell(spec, 2 ** 31 + 11, seconds, False,
                                      "cpu", 0.0, program_factory=factory,
                                      log=lambda m: None)
    return result, checks


@pytest.mark.parametrize("solve", ["lu", "inverse"])
def test_control_fails(tmp_path, solve):
    """The control at the first cell's step (0.55 ns), 100 steps: TF32
    stage products with a float32 solve, and with a TF32 product by the
    inverse, each fail on the numbers of the propagation alone."""
    tiny = dict(TINY, tf_ns=55.0,
                traffic=dict(TINY["traffic"], nsteps=100, batch=2))
    result, checks = _run(make_root(tmp_path, tiny),
                          lambda *a: Control(*a, solve=solve), seconds=0)
    assert not result["correct"], checks
    assert result["failed"] > 0
    assert any(checks[k]["value"] > checks[k]["limit"]
               for k in ("infidelity_rel", "guard_rel", "grad_rel")), checks


class _HalfBatch(Program):
    """Half of the batch left out: the other half's answers are the mean
    over the half computed."""

    def call(self, pcof):
        h = pcof.shape[0] // 2
        out = super().call(pcof[:h])
        return {k: torch.cat([v, v.mean(dim=0, keepdim=True).expand_as(v)])
                for k, v in out.items()}


class _Rolled(Program):
    """Each answer handed to the next vector of the batch."""

    def call(self, pcof):
        return {k: torch.roll(v, 1, dims=0)
                for k, v in super().call(pcof).items()}


def _unchanged_steps(prob, m, dt, P, Q, X0, use_kernels=True,
                     refine_iters=None, forcing=None, precond=None,
                     w_start=None):
    """The L = 1 route's step loop, each step returning its state
    unchanged."""
    for _ in range(P.shape[1] - 1):
        yield w_start.clone()


def _unchanged_segment(wprob, m, dt, P_a, Q_a, P_b, Q_b, w_start, *args,
                       **kwargs):
    """The general-L route's segment history, each step returning its
    state unchanged."""
    shape = (w_start.shape[0], P_a.shape[1] + 1) + tuple(w_start.shape[1:])
    return w_start[:, None].expand(shape).clone()


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "answer_altered"])
def test_planted_fault_fails(tiny_root, monkeypatch, fault):
    factory = Program
    if fault == "unchanged_state":
        import qgd_tpu_torch.segmented as seg

        monkeypatch.setattr(seg, "_step_states", _unchanged_steps)
        monkeypatch.setattr(seg, "_forward_segment_scan", _unchanged_segment)
    elif fault == "half_batch":
        factory = _HalfBatch
    else:
        factory = _Rolled
    result, checks = _run(tiny_root, factory)
    assert not result["correct"], (fault, checks)
    assert result["failed"] > 0


def test_sound_program_passes_with_every_answer_checked(tiny_root):
    result, checks = _run(tiny_root, Program)
    assert result["correct"], checks
    assert result["failed"] == 0
    assert np.isfinite([c["value"] for c in checks.values()]).all()
