"""Stage-solver diagnostics (counterpart of ``qgd_tpu.diagnostics``): the
achieved relative residual of the implicit stage solve ``LHS(t_{n+1})
w_{n+1} = rhs`` at a sample of steps, measured on the port's own solve
(``"schulz"``, ``"lu"`` or ``"gmres"``, kernel route included) with
residuals formed in f64. For ``"gmres"`` the residual is checked against
the requested tolerances, which the fixed-budget solver does not iterate
to, and a warning names a budget too small for them.

The probe states are the ones the propagation actually reaches there,
from one thinned forward pass, so late-time states under large controls,
where a warm-started solve degrades first, are part of the sample. The
GMRES probes solve with the problem's preconditioner, as the propagation
does (the JAX package probes its GMRES stage unpreconditioned).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .controls import as_control_tuple
from .forward import (
    _drift_stage_inverse,
    _hermite_step,
    _make_preconditioner,
    _scenario_pcof,
    _thinned_forward_history,
    _working_tables,
)
from .ops.hermite import assemble_generator_stack, build_lhs, \
    scaled_derivatives
from .ops.linalg import REFINE_SWEEPS_F32


def _probe_indices(nsteps: int, sample: int) -> np.ndarray:
    """Evenly spaced probe steps dividing ``nsteps``."""
    sample = max(1, min(sample, nsteps))
    every = max(nsteps // sample, 1)
    while nsteps % every:
        every -= 1
    return np.arange(0, nsteps, every)


@torch.no_grad()
def stage_residuals(prob, controls, pcof, order: int = 4, sample: int = 8, *,
                    use_kernels: bool = True,
                    refine_sweeps: int | None = None) -> dict:
    """Relative stage-solve residuals at ``sample`` evenly spaced steps, for
    every scenario of ``pcof (S, N_params)`` (or ``(N_params,)``).

    Returns ``{"max", "mean", "solver", "n_sampled"}`` over all probes and
    scenarios. For ``solver="gmres"`` a ``UserWarning`` is issued when the
    largest residual exceeds ``max(gmres_abstol, gmres_reltol)``.
    """
    controls = as_control_tuple(controls)
    pcof, _ = _scenario_pcof(prob, pcof)
    m = order // 2
    wprob, dt64, dt, P, Q = _working_tables(prob, controls, pcof, m)
    if prob.work_dtype == torch.float32:
        sweeps = REFINE_SWEEPS_F32 if refine_sweeps is None else refine_sweeps
    else:
        sweeps = 4
    idx = _probe_indices(prob.nsteps, sample)
    every = int(idx[1] - idx[0]) if idx.size > 1 else prob.nsteps
    w_probe = _thinned_forward_history(prob, controls, pcof, order, every,
                                       use_kernels, sweeps)
    X0 = (_drift_stage_inverse(wprob, m, dt)
          if prob.solver == "schulz" else None)
    precond = _make_preconditioner(prob, dt64, order)

    res = []
    for k, i in enumerate(idx):
        i = int(i)
        w_next, lhs, rhs = _hermite_step(
            wprob, m, dt, w_probe[:, k], (P[:, i], Q[:, i]),
            (P[:, i + 1], Q[:, i + 1]), schulz_X0=X0,
            use_kernels=use_kernels, refine_iters=sweeps, precond=precond)
        if lhs is None:         # GMRES: the stage matrix, built to check
            A = assemble_generator_stack(wprob, P[:, i + 1], Q[:, i + 1], m)
            eye = torch.eye(prob.real_system_size, dtype=A.dtype,
                            device=A.device)
            lhs = build_lhs(scaled_derivatives(A, eye, m), dt, m)
        rhs64 = rhs.to(torch.float64)
        r = rhs64 - lhs.to(torch.float64) @ w_next.to(torch.float64)
        norm = lambda x: torch.sqrt(torch.sum(x * x, dim=(-2, -1)))
        res.append(norm(r) / torch.clamp(norm(rhs64), min=1e-300))
    res = torch.stack(res).cpu().numpy()
    out = {"max": float(res.max()), "mean": float(res.mean()),
           "solver": prob.solver, "n_sampled": int(res.size)}
    if prob.solver == "gmres":
        tol = max(prob.gmres_abstol, prob.gmres_reltol)
        if out["max"] > tol:
            warnings.warn(
                f"qgd_tpu_torch: fixed-budget GMRES stage residual "
                f"{out['max']:.2e} exceeds requested tolerance {tol:.2e} "
                f"(gmres_abstol/gmres_reltol); increase prob.gmres_iters.",
                stacklevel=2)
    return out
