"""Full-setup checkpointing of optimization runs (counterpart of
``qgd_tpu.checkpoint``), in the JAX package's file format, so a setup saved
by either package loads in the other.

Format: ``<name>.setup.json`` (static metadata and control specs) plus
``<name>.setup.npz`` (all arrays). Controls are frozen dataclasses and
round-trip generically: each field is a scalar, an array or a nested
control, serialized by class name against the registry of the port's
control classes (the same names and fields as the JAX package's, every
family of it). The problem's static fields, the GMRES settings included,
carry over both ways.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .controls.base import Control, as_control_tuple
from .problem import SchrodingerProblem, problem_from_arrays


# ---------------------------------------------------------------------------
# Control (de)serialization
# ---------------------------------------------------------------------------

def _control_registry() -> dict:
    """All concrete Control subclasses by class name."""
    from .controls import (analytic, bspline, carrier, deboor,  # noqa: F401
                           hermite)

    reg = {}

    def walk(cls):
        for sub in cls.__subclasses__():
            reg[sub.__name__] = sub
            walk(sub)

    walk(Control)
    return reg


def control_to_spec(ctrl: Control, arrays: dict, prefix: str) -> dict:
    """Recursively serialize a control dataclass. Arrays go into ``arrays``
    under ``prefix``-derived keys; the returned spec is JSON-safe."""
    spec = {"__control__": type(ctrl).__name__, "fields": {}}
    for f in dataclasses.fields(ctrl):
        v = getattr(ctrl, f.name)
        key = f"{prefix}.{f.name}"
        if isinstance(v, Control):
            spec["fields"][f.name] = control_to_spec(v, arrays, key)
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            arrays[key] = (v.detach().cpu().numpy()
                           if isinstance(v, torch.Tensor) else v)
            spec["fields"][f.name] = {"__array__": key}
        elif isinstance(v, (bool, int, float, str)) or v is None:
            spec["fields"][f.name] = v
        elif isinstance(v, (tuple, list)):
            spec["fields"][f.name] = {"__seq__": list(v)}
        else:
            raise TypeError(
                f"cannot serialize control field {f.name} of type {type(v)}")
    return spec


def control_from_spec(spec: dict, arrays: dict) -> Control:
    reg = _control_registry()
    name = spec["__control__"]
    if name not in reg:
        raise ValueError(f"unknown control class {name!r} (the port has "
                         f"{sorted(reg)})")
    kwargs = {}
    for field, v in spec["fields"].items():
        if isinstance(v, dict) and "__control__" in v:
            kwargs[field] = control_from_spec(v, arrays)
        elif isinstance(v, dict) and "__array__" in v:
            kwargs[field] = np.asarray(arrays[v["__array__"]])
        elif isinstance(v, dict) and "__seq__" in v:
            kwargs[field] = tuple(v["__seq__"])
        else:
            kwargs[field] = v
    return reg[name](**kwargs)


# ---------------------------------------------------------------------------
# Problem (de)serialization
# ---------------------------------------------------------------------------

_PROB_ARRAYS = ("system_sym", "system_asym", "sym_operators",
                "asym_operators", "u0", "v0", "guard_subspace_projector",
                "tf")
_PROB_STATIC = ("nsteps", "N_ess_levels", "solver", "schulz_iters",
                "schulz_warm_budget", "gmres_abstol", "gmres_reltol",
                "gmres_iters", "preconditioner_type", "dtype",
                "hoist_batch_hint")


def problem_to_spec(prob: SchrodingerProblem, arrays: dict) -> dict:
    for name in _PROB_ARRAYS:
        v = getattr(prob, name)
        arrays[f"prob.{name}"] = (v.detach().cpu().numpy()
                                  if isinstance(v, torch.Tensor)
                                  else np.asarray(v))
    return {name: getattr(prob, name) for name in _PROB_STATIC}


def problem_from_spec(spec: dict, arrays: dict,
                      device="cuda") -> SchrodingerProblem:
    """The port's problem on ``device`` from a spec written by either
    package; fields the port does not carry are ignored."""
    a = {k: arrays[f"prob.{k}"] for k in _PROB_ARRAYS}
    static = {k: spec[k] for k in _PROB_STATIC if k in spec}
    hint = static.pop("hoist_batch_hint", 1)
    prob = problem_from_arrays(a, device=device, **static)
    return dataclasses.replace(prob, hoist_batch_hint=int(hint))


# ---------------------------------------------------------------------------
# Setup save / load / resume
# ---------------------------------------------------------------------------

def save_setup(filename: str, prob, controls, target, *, order: int = 4,
               pcof_L=None, pcof_U=None, ridge_penalty_strength: float = 1e-2,
               cost_type: str = "Infidelity", **extra_options):
    """Persist the full optimization setup (problem, controls, target,
    bounds, order and options). Written once per run by
    ``optimize_gate(filename=...)``."""
    arrays = {}
    controls = as_control_tuple(controls)
    spec = {
        "problem": problem_to_spec(prob, arrays),
        "controls": [control_to_spec(c, arrays, f"ctrl{i}")
                     for i, c in enumerate(controls)],
        "order": int(order),
        "ridge_penalty_strength": float(ridge_penalty_strength),
        "cost_type": cost_type,
        "options": {k: v for k, v in extra_options.items()
                    if isinstance(v, (bool, int, float, str)) or v is None},
    }
    if isinstance(target, torch.Tensor):
        target = target.detach().cpu().numpy()
    tgt = np.asarray(target)
    if np.iscomplexobj(tgt):
        arrays["target.re"] = tgt.real
        arrays["target.im"] = tgt.imag
        spec["target_complex"] = True
    else:
        arrays["target.re"] = tgt
        spec["target_complex"] = False
    for name, b in (("pcof_L", pcof_L), ("pcof_U", pcof_U)):
        if isinstance(b, torch.Tensor):
            b = b.detach().cpu().numpy()
        if b is None:
            spec[name] = None
        elif np.ndim(b) == 0:
            spec[name] = float(b)
        else:
            arrays[name] = np.asarray(b, dtype=np.float64)
            spec[name] = {"__array__": name}
    with open(filename + ".setup.json", "w") as f:
        json.dump(spec, f)
    np.savez_compressed(filename + ".setup.npz", **arrays)


def load_setup(filename: str, device="cuda") -> dict:
    """Load a persisted setup: a dict with ``prob`` (on ``device``, the
    card by default), ``controls``, ``target``, ``order``,
    ``pcof_L``/``pcof_U``, ``ridge_penalty_strength``, ``cost_type`` and
    the extra options."""
    with open(filename + ".setup.json") as f:
        spec = json.load(f)
    with np.load(filename + ".setup.npz", allow_pickle=False) as npz:
        arrays = dict(npz)
    prob = problem_from_spec(spec["problem"], arrays, device=device)
    controls = tuple(control_from_spec(s, arrays) for s in spec["controls"])
    if spec["target_complex"]:
        target = arrays["target.re"] + 1j * arrays["target.im"]
    else:
        target = arrays["target.re"]

    def bound(name):
        v = spec[name]
        if isinstance(v, dict) and "__array__" in v:
            return arrays[v["__array__"]]
        return v

    return dict(prob=prob, controls=controls, target=target,
                order=spec["order"],
                pcof_L=bound("pcof_L"), pcof_U=bound("pcof_U"),
                ridge_penalty_strength=spec["ridge_penalty_strength"],
                cost_type=spec["cost_type"], **spec.get("options", {}))


def verify_history_f64(filename: str, which: str = "best",
                       device="cuda") -> dict:
    """f64 verification of a recorded optimization: rebuild the setup on
    ``device``, force ``dtype="float64"``, re-evaluate the recorded
    ``best`` (min objective) or ``last`` pcof, and write the comparison to
    ``<filename>.f64check.json``. Returns the record."""
    from .objective import objective_parts
    from .optimize import OptimizationHistory

    setup = load_setup(filename, device=device)
    hist = OptimizationHistory.load(filename)
    idx = (int(np.argmin(hist.obj_value)) if which == "best"
           else len(hist.obj_value) - 1)
    prob = dataclasses.replace(setup["prob"], dtype="float64")
    j1, guard, ridge = (float(x) for x in objective_parts(
        prob, setup["controls"], np.asarray(hist.pcof[idx]), setup["target"],
        setup["order"],
        ridge_penalty_strength=setup["ridge_penalty_strength"],
        cost_type=setup["cost_type"]))
    rec = {
        "which": which, "eval_index": idx,
        "recorded_objective": float(hist.obj_value[idx]),
        "recorded_infidelity": float(hist.infidelity[idx]),
        "f64_infidelity": j1,
        "f64_guard": guard,
        "f64_objective": j1 + guard + ridge,
        "delta_infidelity": j1 - float(hist.infidelity[idx]),
        "delta_objective": (j1 + guard + ridge) - float(hist.obj_value[idx]),
    }
    with open(filename + ".f64check.json", "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def resume_optimization(filename: str, device="cuda", **overrides):
    """Resume an optimization run from its checkpoint files alone: rebuild
    the problem (on ``device``), controls, target and bounds from
    ``<filename>.setup.*`` and restart ``optimize_gate`` from the last
    recorded pcof, appending to the loaded history. ``overrides`` replace
    saved options (e.g. a larger ``maxIter``)."""
    from .optimize import optimize_gate

    setup = load_setup(filename, device=device)
    setup.update(overrides)
    return optimize_gate(
        setup.pop("prob"), setup.pop("controls"), None,
        setup.pop("target"), resume_from=filename, filename=filename,
        **setup)
