"""Stage-solver diagnostics (counterpart of ``qgd_tpu.diagnostics``,
``solver="schulz"``): the achieved relative residual of the implicit stage
solve ``LHS(t_{n+1}) w_{n+1} = rhs`` at a sample of steps, measured on the
port's own solve (kernel route included) with residuals formed in f64.

The probe states are the ones the propagation actually reaches there, so
late-time states under large controls, where a warm-started solve degrades
first, are part of the sample.
"""

from __future__ import annotations

import numpy as np
import torch

from .controls import as_control_tuple, control_tables
from .forward import (
    _time_grid,
    _drift_stage_inverse,
    _forward_trajectory,
    _hermite_step,
)
from .ops.linalg import REFINE_SWEEPS_F32
from .problem import working_problem


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
    scenarios.
    """
    if prob.solver != "schulz":
        raise NotImplementedError(
            f"solver={prob.solver!r}: only 'schulz' is ported")
    controls = as_control_tuple(controls)
    dev = prob.device
    pcof = torch.as_tensor(pcof, dtype=torch.float64).to(dev)
    if pcof.dim() == 1:
        pcof = pcof[None]
    m = order // 2
    dt64, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    wprob = working_problem(prob)
    P, Q = P.to(wd), Q.to(wd)
    dt = torch.tensor(dt64, dtype=torch.float64, device=dev).to(wd)
    if wd == torch.float32:
        sweeps = REFINE_SWEEPS_F32 if refine_sweeps is None else refine_sweeps
    else:
        sweeps = 4
    X0 = _drift_stage_inverse(wprob, m, dt)
    traj = _forward_trajectory(wprob, m, dt, P, Q, X0, use_kernels, sweeps)

    res = []
    for i in _probe_indices(prob.nsteps, sample):
        i = int(i)
        w_next, lhs, rhs = _hermite_step(
            wprob, m, dt, traj[:, i], (P[:, i], Q[:, i]),
            (P[:, i + 1], Q[:, i + 1]), schulz_X0=X0,
            use_kernels=use_kernels, refine_iters=sweeps)
        rhs64 = rhs.to(torch.float64)
        r = rhs64 - lhs.to(torch.float64) @ w_next.to(torch.float64)
        norm = lambda x: torch.sqrt(torch.sum(x * x, dim=(-2, -1)))
        res.append(norm(r) / torch.clamp(norm(rhs64), min=1e-300))
    res = torch.stack(res).cpu().numpy()
    return {"max": float(res.max()), "mean": float(res.mean()),
            "solver": prob.solver, "n_sampled": int(res.size)}
