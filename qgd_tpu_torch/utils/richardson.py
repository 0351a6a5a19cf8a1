"""Convergence and timing harness (counterpart of
``qgd_tpu.utils.richardson``; the reference's
``src/Tests/test_convergence.jl``).

``get_histories`` runs each method order at successively doubled step
counts, times the forward solves, and estimates the error of each
refinement by Richardson extrapolation against the next-finer one: the
reference's accuracy and speed metric (runtime to reach a target
relative error). Histories come back as numpy arrays, so the results
serialize as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import OrderedDict

import numpy as np
import torch


def richardson_extrap_sol(sol_h, sol_2h, order: int):
    """``(2^n A_h - A_2h) / (2^n - 1)``."""
    f = 2.0 ** order
    return (f * sol_h - sol_2h) / (f - 1.0)


def richardson_extrap_rel_err(sol_h, sol_2h, order: int):
    """Relative error estimate of ``sol_h`` with the extrapolant as the
    truth."""
    extrap = richardson_extrap_sol(sol_h, sol_2h, order)
    return float(np.linalg.norm(np.asarray(sol_h - extrap))
                 / np.linalg.norm(np.asarray(extrap)))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def get_histories(prob, controls, pcof, N_iterations: int, *, orders=(2, 4),
                  base_nsteps=None, nsteps_change_factor: int = 2,
                  min_error_limit: float = -np.inf,
                  max_error_limit: float = np.inf,
                  jld2_filename: str | None = None, verbose: bool = True,
                  with_diagnostics: bool = False):
    """Timed convergence sweep.

    For each order, ``N_iterations`` forward solves of the 1-D ``pcof``
    with ``nsteps = base_nsteps * factor^k``, each saved on the coarsest
    grid so all runs are comparable; records wall-clock seconds and
    Richardson errors. An order stops early when its error drops below
    ``min_error_limit`` or stops decreasing (saturation at roundoff).

    Each solve is run once untimed first (the kernels' build and the
    allocator's first requests are set-up), then timed between
    ``torch.cuda.synchronize()`` calls on the card. Returns an
    OrderedDict ``{"Order k": {"histories": [...], "elapsed": [...],
    "nsteps": [...], "rel_errs": [...]}}`` with numpy histories; with
    ``jld2_filename`` the results are dumped after each order as
    ``<name>.json`` + ``<name>.npz``. ``with_diagnostics=True`` also
    records each run's stage-solve residual (``"stage_residual"``).
    """
    from ..forward import eval_forward

    if base_nsteps is None:
        base_nsteps = prob.nsteps
    results = OrderedDict()
    for order in orders:
        key = f"Order {order}"
        entry = dict(histories=[], elapsed=[], nsteps=[], rel_errs=[])
        if with_diagnostics:
            entry["stage_residual"] = []
        results[key] = entry
        prev_final = None
        prev_err = np.inf
        for k in range(N_iterations):
            nsteps = base_nsteps * nsteps_change_factor ** k
            p = dataclasses.replace(prob, nsteps=nsteps)
            save_every = nsteps_change_factor ** k
            eval_forward(p, controls, pcof, order, save_every=save_every)
            _sync(p.device)
            t0 = time.perf_counter()
            hist = eval_forward(p, controls, pcof, order,
                                save_every=save_every)
            _sync(p.device)
            elapsed = time.perf_counter() - t0
            hist = hist.detach().cpu().numpy()
            entry["histories"].append(hist)
            entry["elapsed"].append(elapsed)
            entry["nsteps"].append(nsteps)
            if with_diagnostics:
                from ..diagnostics import stage_residuals

                entry["stage_residual"].append(
                    stage_residuals(p, controls, pcof, order))
            if prev_final is not None:
                rel_err = richardson_extrap_rel_err(hist[-1], prev_final,
                                                    order)
                entry["rel_errs"].append(rel_err)
                if verbose:
                    print(f"[{key}] nsteps={nsteps} rel_err={rel_err:.3e} "
                          f"elapsed={elapsed:.3f}s")
                if rel_err < min_error_limit:
                    break
                if rel_err > prev_err and rel_err < max_error_limit:
                    break
                prev_err = rel_err
            elif verbose:
                print(f"[{key}] nsteps={nsteps} elapsed={elapsed:.3f}s")
            prev_final = hist[-1]
        if jld2_filename is not None:
            _dump(results, jld2_filename)
    return results


def _dump(results, filename: str):
    meta = {k: {kk: v[kk] for kk in ("elapsed", "nsteps", "rel_errs")}
            for k, v in results.items()}
    with open(filename + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    arrays = {}
    for k, v in results.items():
        for i, h in enumerate(v["histories"]):
            arrays[f"{k}/history_{i}"] = h
    np.savez_compressed(filename + ".npz", **arrays)


def find_target_y(x1, y1, x2, y2, target_y):
    """Log-log interpolation of the x at which y reaches ``target_y``."""
    lx1, ly1, lx2, ly2 = (np.log(v) for v in (x1, y1, x2, y2))
    lt = np.log(target_y)
    lx = lx1 + (lt - ly1) * (lx2 - lx1) / (ly2 - ly1)
    return float(np.exp(lx))


def get_runtime_ratios(results, results_reference, target_error: float = 1e-7,
                       extrapolate: bool = False):
    """Runtime-to-target-error ratios against a reference sweep (both
    ``get_histories`` results): ``{order_key: ratio}``.

    The target must be bracketed by a sweep, or, with ``extrapolate``,
    reachable by extending its last log-log segment (an asymptotic
    estimate, not a measurement). An order of ``results`` that cannot
    reach the target maps to ``None``; a reference sweep that cannot
    raises ValueError, as there is no ratio without it."""
    def runtime_to_target(entry):
        errs, times = entry["rel_errs"], entry["elapsed"][1:]
        for i in range(1, len(errs)):
            if errs[i] <= target_error <= errs[i - 1]:
                return find_target_y(times[i - 1], errs[i - 1], times[i],
                                     errs[i], target_error)
        if extrapolate and len(errs) >= 2 and errs[-1] > target_error:
            return find_target_y(times[-2], errs[-2], times[-1], errs[-1],
                                 target_error)
        raise ValueError("target error not bracketed by sweep")

    ref_key = next(iter(results_reference))
    ref_rt = runtime_to_target(results_reference[ref_key])
    out = {}
    for k, v in results.items():
        try:
            out[k] = runtime_to_target(v) / ref_rt
        except ValueError:
            out[k] = None
    return out
