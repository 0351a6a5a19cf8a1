"""Juqbox-class Stormer-Verlet baseline (counterpart of
``qgd_tpu.models.juqbox_verlet``; the reference's ``ext/JuqboxHelpers.jl``).

The reference's speed metric is the runtime to reach a relative error of
1e-7 against Juqbox.jl's order-2 Stormer-Verlet propagator. This module
is that scheme, the partitioned (Lobatto IIIA/IIIB) Stormer-Verlet method
of Petersson & Garcia, on the real-stacked system

    du/dt =  S(t) u + K(t) v
    dv/dt = -K(t) u + S(t) v

one step ``t_n -> t_{n+1} = t_n + dt``:

    (I - dt/2 S_n)     v_half  = v_n + dt/2 (-K_n u_n)
    (I - dt/2 S_{n+1}) u_{n+1} = u_n + dt/2 (S_n u_n + (K_n + K_{n+1}) v_half)
    v_{n+1} = v_half + dt/2 (-K_{n+1} u_{n+1} + S_{n+1} v_half)

two N x N solves and a few products per step, in float64 torch on the
problem's device (the card unless the problem was built on the CPU).
:func:`verlet_histories` gives the result structure of
``utils.richardson.get_histories``, so ``get_runtime_ratios(ours,
verlet_histories(...))`` yields the reference's runtime-ratio table.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch


def verlet_forward(prob, controls, pcof, *, save_every: int = 1):
    """Propagate the 1-D ``pcof`` with the order-2 Stormer-Verlet scheme:
    the real-stacked history ``(nsteps // save_every + 1, 2N, B)``, float64
    on ``prob.device``, on the save grid of ``eval_forward``."""
    from ..controls import as_control_tuple, control_tables

    nsteps = prob.nsteps
    if nsteps % save_every != 0:
        raise ValueError("nsteps must be divisible by save_every")
    dev, f64 = prob.device, torch.float64
    dt = prob.tf / nsteps
    ts = torch.as_tensor(np.linspace(0.0, prob.tf, nsteps + 1)).to(dev)
    pcof = torch.as_tensor(pcof, dtype=f64).to(dev)
    P, Q = control_tables(as_control_tuple(controls), pcof, ts, 1)
    P, Q = P[:, 0, :], Q[:, 0, :]                     # (T+1, N_ops)

    Kd, Sd = prob.system_sym.to(f64), prob.system_asym.to(f64)
    sym, asym = prob.sym_operators.to(f64), prob.asym_operators.to(f64)
    N = Kd.shape[0]
    eye = torch.eye(N, dtype=f64, device=dev)
    u, v = prob.u0.to(f64), prob.v0.to(f64)

    def KS(n):
        return (Kd + torch.einsum("j,jab->ab", P[n], sym),
                Sd + torch.einsum("j,jab->ab", Q[n], asym))

    hist = torch.empty((nsteps // save_every + 1, 2 * N, u.shape[1]),
                       dtype=f64, device=dev)
    hist[0, :N], hist[0, N:] = u, v
    K1, S1 = KS(0)
    for n in range(nsteps):
        K0, S0 = K1, S1
        K1, S1 = KS(n + 1)
        v_half = torch.linalg.solve(eye - 0.5 * dt * S0,
                                    v - 0.5 * dt * (K0 @ u))
        u = torch.linalg.solve(
            eye - 0.5 * dt * S1,
            u + 0.5 * dt * (S0 @ u + (K0 + K1) @ v_half))
        v = v_half + 0.5 * dt * (S1 @ v_half - K1 @ u)
        if (n + 1) % save_every == 0:
            k = (n + 1) // save_every
            hist[k, :N], hist[k, N:] = u, v
    return hist


def verlet_histories(prob, controls, pcof, N_iterations: int, *,
                     base_nsteps=None, nsteps_change_factor: int = 2,
                     min_error_limit: float = -np.inf,
                     verbose: bool = True):
    """Timed convergence sweep of the Verlet baseline in the result format
    of ``get_histories`` (order 2, doubled steps, seconds between
    ``torch.cuda.synchronize()`` calls on the card, Richardson errors;
    numpy histories)."""
    from ..utils.richardson import _sync, richardson_extrap_rel_err

    if base_nsteps is None:
        base_nsteps = prob.nsteps
    entry = dict(histories=[], elapsed=[], nsteps=[], rel_errs=[])
    prev_final = None
    for k in range(N_iterations):
        nsteps = base_nsteps * nsteps_change_factor ** k
        p = dataclasses.replace(prob, nsteps=nsteps)
        save_every = nsteps_change_factor ** k
        _sync(p.device)
        t0 = time.perf_counter()
        hist = verlet_forward(p, controls, pcof, save_every=save_every)
        _sync(p.device)
        elapsed = time.perf_counter() - t0
        hist = hist.cpu().numpy()
        entry["histories"].append(hist)
        entry["elapsed"].append(elapsed)
        entry["nsteps"].append(nsteps)
        if prev_final is not None:
            rel_err = richardson_extrap_rel_err(hist[-1], prev_final, 2)
            entry["rel_errs"].append(rel_err)
            if verbose:
                print(f"[Verlet order 2] nsteps={nsteps} "
                      f"rel_err={rel_err:.3e} elapsed={elapsed:.3f}s",
                      flush=True)
            if rel_err < min_error_limit:
                break
        elif verbose:
            print(f"[Verlet order 2] nsteps={nsteps} elapsed={elapsed:.3f}s",
                  flush=True)
        prev_final = hist[-1]
    return OrderedDict({"Verlet order 2": entry})
