"""One run of one cell: set-up, the measured window, the trace, and the
comparison that decides ``correct``.

Everything a cell needs is found by name from ``BENCHMARK.json`` at the
root of the checkout: its configuration (the ``file`` of its entry in
``configs``), its traffic mix (``qgdbench/traffic/<traffic>.json``), the
limits of its comparison (``qgdbench/limits/<cell>.json``) and a reader per
per-layer metric (``qgdbench/metrics/<metric>.py``, a function
``read(ctx)`` that returns a number or ``None``). Adding a cell, a
configuration, a traffic mix or a metric adds files and entries; no code
here names one.

The traffic is a closed loop with one caller: each call is one batched
objective + gradient on ``batch`` fresh control vectors drawn from the
seed, uniform in +-``start_fraction * amplitude_bound``; the next call
starts when the previous one has returned and the device is synchronised.
The first call, which captures the step programs, is set-up. A traced
run profiles the traffic's ``trace_calls`` calls and makes no others. A call
counts ``2 * nsteps * batch`` Hermite steps (a forward and an adjoint
step per time step and vector; a re-forward is not counted). The rate is
the steps of all calls that started in the window over the time from the
window's start to the end of the last of them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import system
from .reference.hermite import Reference

# programs whose loading in the result's process voids a run: the port
# runs without JAX, and qgd_tpu is the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "qgd_tpu")
COUNTED_PASSES = 2          # forward + adjoint step per time step


def forbidden_modules(modules=None) -> list:
    """Names in ``sys.modules`` whose top-level name (the part before the
    first dot) is one of :data:`FORBIDDEN_MODULES`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN_MODULES)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root, cell: str) -> dict:
    """The spec of ``cell``: ``{"cell", "config", "traffic", "limits",
    "end_to_end", "per_layer", "root"}``, each from its own file under
    ``root``."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    in_cell = lambda m: cell in m.get("workloads", [cell])
    return {
        "root": root,
        "cell": w,
        "config": _json(root / configs[w["config"]]["file"]),
        "traffic": _json(root / "qgdbench" / "traffic"
                         / f"{w['traffic']}.json"),
        "limits": _json(root / "qgdbench" / "limits" / f"{cell}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if in_cell(m)],
        "per_layer": [m for m in bench["per_layer"] if in_cell(m)],
    }


def load_reader(root, metric: str):
    """The ``read(ctx)`` of per-layer metric ``metric``."""
    path = Path(root) / "qgdbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "qgdbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Draw:
    """The traffic's control vectors: call after call from one generator
    on the device, seeded once."""

    def __init__(self, spec, n_params: int, seed: int, device):
        import torch

        traffic, config = spec["traffic"], spec["config"]
        self.shape = (int(traffic["batch"]), n_params)
        self.amp = float(traffic["start_fraction"]) * float(
            config["amplitude_bound"])
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))

    def __call__(self):
        import torch

        u = torch.rand(self.shape, generator=self.gen, dtype=torch.float64,
                       device=self.device)
        return (2.0 * u - 1.0) * self.amp


def compare(outs: dict, ref: dict) -> dict:
    """Per sampled vector, the numbers compared: the relative gaps of the
    three objective parts and of the gradient (its norm-2) from the
    reference (``outs`` and ``ref`` float64 numpy, the same rows)."""
    rel = lambda k: np.abs(outs[k] - ref[k]) / np.abs(ref[k])
    grad = (np.linalg.norm(outs["grad"] - ref["grad"], axis=-1)
            / np.linalg.norm(ref["grad"], axis=-1))
    return {"infidelity_rel": rel("infidelity"), "guard_rel": rel("guard"),
            "ridge_rel": rel("ridge"), "grad_rel": grad}


def sample_rows(seed: int, total: int, n: int) -> np.ndarray:
    """The ``min(n, total)`` answers, of ``total``, that the comparison
    checks: distinct, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0x5A11])
    return rng.choice(total, size=min(int(n), total), replace=False)


def _nonfinite(out: dict) -> int:
    import torch

    bad = ~torch.isfinite(out["grad"]).all(dim=-1)
    for k in ("infidelity", "guard", "ridge"):
        bad |= ~torch.isfinite(out[k])
    return int(bad.sum())


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_process_start: float, program_factory=None,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)):
    """One run (module docstring). Returns ``(result, checks)``: the
    result line's dict without ``device``'s card fields, and the numbers
    compared, each ``{"value", "limit"}``.

    ``program_factory(config, traffic, inputs, device)`` builds the
    system under test (default :class:`qgdbench.program.Program`)."""
    import torch

    config, traffic = spec["config"], spec["traffic"]
    nsteps, batch = int(traffic["nsteps"]), int(traffic["batch"])
    is_cuda = torch.device(device).type == "cuda"
    if program_factory is None:
        from .program import Program as program_factory

    # ------------------------------ set-up ---------------------------------
    inputs = system.build_inputs(config)
    draw = Draw(spec, inputs["n_params"], seed, device)
    t0 = time.perf_counter()
    program = program_factory(config, traffic, inputs, device)
    _sync(device)
    t1 = time.perf_counter()
    program.call(draw())                     # builds, captures: set-up
    _sync(device)
    t2 = time.perf_counter()
    log(f"set-up: {t0 - t_process_start:.3f} s to the program, "
        f"{t1 - t0:.3f} s to build it, {t2 - t1:.3f} s for the first call "
        f"(kernels built and loaded, programs captured)")
    tracer = None
    if trace:
        from .profiling import Tracer

        warm = Tracer()                      # the profiler's own start-up
        warm.start()
        torch.ones(1, device=device).add_(1)
        _sync(device)
        warm.stop()
        tracer = Tracer()
    setup_peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()

    # ------------------------------ window ---------------------------------
    # a traced run reports no end-to-end metric: it makes its traced calls
    # and no more, and the comparison samples those
    trace_calls = max(1, int(traffic["trace_calls"])) if trace else 0
    calls, ends = [], []
    t_win = time.perf_counter()
    setup_s = t_win - t_process_start
    deadline = t_win + seconds
    more = ((lambda: len(calls) < trace_calls) if trace else
            (lambda: not calls or time.perf_counter() < deadline))
    if trace:
        tracer.start()
    while more():
        pcof = draw()
        out = program.call(pcof)
        _sync(device)
        ends.append(time.perf_counter())
        calls.append((pcof, out))
    window_s = ends[-1] - t_win
    if trace:
        tracer.stop()
    window_peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    steps = COUNTED_PASSES * nsteps * batch * len(calls)
    durations = np.diff([t_win] + ends)
    log(f"window: {len(calls)} calls in {window_s:.4f} s; per call min "
        f"{durations.min():.4f} median {np.median(durations):.4f} max "
        f"{durations.max():.4f} s; program {program.stats()}")

    result = {"correct": False, "attempted": len(calls) * batch,
              "failed": 0, "metrics": {},
              "device": {"memory_peak_bytes": int(max(setup_peak,
                                                      window_peak))}}
    if not trace:
        for m in spec["end_to_end"]:
            value = {"steps_per_s": steps / window_s,
                     "setup_s": setup_s}[m["name"]]
            result["metrics"][m["name"]] = {"value": value,
                                            "unit": m["unit"]}
    else:
        from . import profiling as tr

        tt = tracer.reduce()
        busy = tr.busy_intervals(tt["device"])
        busy_s = sum(e - s for s, e in busy) / 1e9
        ctx = {"device_ops": tt["device"], "busy_s": busy_s,
               "window_s": window_s, "calls": trace_calls,
               "nsteps": nsteps, "batch": batch, "m": int(config["order"]) // 2,
               "n": 2 * inputs["H0"].shape[0], "b": inputs["N_ess"],
               "peak_mem_bytes": window_peak}
        for m in spec["per_layer"]:
            value = load_reader(spec["root"], m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"].update(busy_s=busy_s, window_s=window_s)
        result["breakdown"] = {
            "device_ops": tr.top_device_ops(tt["device"]),
            "idle_gaps": tr.idle_gaps(busy, tt["host"])}
        del tt, tracer

    # ------------------------ the comparison -------------------------------
    nonfinite = sum(_nonfinite(out) for _, out in calls)
    picks = sample_rows(seed, len(calls) * batch, traffic["sample"])
    n_sample = len(picks)
    pcof = torch.stack([calls[i // batch][0][i % batch] for i in picks])
    outs = {k: torch.stack([calls[i // batch][1][k][i % batch]
                            for i in picks]).double().cpu().numpy()
            for k in ("infidelity", "guard", "ridge", "grad")}
    del calls, program
    if is_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = Reference(inputs, int(config["order"]), nsteps, config["ridge"],
                    device).evaluate(pcof)
    per_row = compare(outs, ref)
    log(f"reference: {n_sample} sampled vectors in "
        f"{time.perf_counter() - t_ref:.2f} s")
    limits = spec["limits"]
    checks = {k: {"value": float(np.max(v)), "limit": limits[k]}
              for k, v in per_row.items()}
    checks["nonfinite"] = {"value": nonfinite, "limit": limits["nonfinite"]}
    over = np.zeros(n_sample, dtype=bool)
    for k, v in per_row.items():
        over |= ~(v <= limits[k])
    result["failed"] = int(over.sum()) + nonfinite
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    return result, checks
