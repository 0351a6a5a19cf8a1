"""Named spans for a profiler's trace of the port.

``with span("qgd.forward"): ...`` records a host range named
``qgd.forward`` in the trace of a ``torch.profiler`` that is recording,
and does nothing otherwise. There is no switch: tracing is on exactly
while a profiler records. With it off a span costs one read of the
profiler's flag; it reads no clock, allocates nothing and never
synchronises the device.

A span is a record function of the operator scope, the scope an
``aten::`` operator has, not ``torch.profiler.record_function``'s user
scope: the profiler mirrors a user-scope range that launched device work
as a range on the device's timeline (``gpu_user_annotation``), which a
reader of the trace's device operations would count as device work.
Spans sit on the host's timeline only; the device work a span launched is
found through the launch's correlation id, and shares the trace's clock.

The spans of :mod:`qgd_tpu_torch.segmented`:

* ``qgd.call``: one call of ``segmented_objective_and_gradient`` or
  ``segmented_objective_value``; inside it, in order, ``qgd.tables``
  (control tables, the call's ``_Work``), ``qgd.forward`` (the step
  programs' forward with its loads and copies, the guard sum),
  ``qgd.terminal`` (terminal cost, the tables at ``t_f``, the terminal
  multiplier), ``qgd.backward`` (the backward's programs with their loads
  and copies) and ``qgd.table_vjp`` (the pcof chain rule through the
  tables, the sums over a column group, the ridge term);
* ``qgd.replay.fwd``, ``qgd.replay.bwd``: one run of a forward or backward
  program that was captured before (its graph's replay) or is not
  captured at all (an eager run), in ``_Programs.run``. The run that
  captures a program has none.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager recording the host range ``name`` while a
    profiler records; otherwise one shared ``nullcontext``."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
