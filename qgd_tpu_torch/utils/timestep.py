"""Timestep estimation (counterpart of ``qgd_tpu.utils.timestep``; the
reference's ``src/calculate_timestep.jl``)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..controls import GRAPEControl


def _np(x):
    return x.detach().cpu().numpy()


def get_shortest_period(prob, max_amplitudes):
    """Shortest period ``2 pi / max |eig(H_max)|`` of the Hamiltonian with
    every control at its maximum amplitude (numpy eigenvalues)."""
    H = _np(prob.system_sym) + 1j * _np(prob.system_asym)
    sym, asym = _np(prob.sym_operators), _np(prob.asym_operators)
    for i in range(prob.N_operators):
        H = H + max_amplitudes[i] * sym[i]
        H = H + 1j * max_amplitudes[i] * asym[i]
    eigs = np.linalg.eigvals(H)
    return 2 * np.pi / np.max(np.abs(eigs))


def estimate_N_timesteps(prob, max_amplitudes, timesteps_per_period=40):
    """Steps needed for ``timesteps_per_period`` steps per shortest
    period."""
    shortest = get_shortest_period(prob, max_amplitudes)
    periods = float(prob.tf) / shortest
    return int(math.ceil(periods * timesteps_per_period))


def estimate_timesteps_per_period(prob, max_amplitudes, order: int,
                                  resolutions=None, verbose: bool = False):
    """Richardson sweep over steps-per-period resolutions 2^-3..2^6 with
    constant controls at the maximum amplitudes; returns the list of
    successive-refinement relative errors."""
    from ..forward import eval_forward
    from .richardson import richardson_extrap_rel_err

    if resolutions is None:
        resolutions = [2.0 ** i for i in range(-3, 7)]
    controls = [GRAPEControl(1, float(prob.tf))
                for _ in range(prob.N_operators)]
    pcof = np.repeat(np.asarray(max_amplitudes, dtype=np.float64), 2)

    rel_errors = []
    prev_final = None
    for res in resolutions:
        nsteps = estimate_N_timesteps(prob, max_amplitudes, res)
        p = dataclasses.replace(prob, nsteps=max(nsteps, 1))
        final = _np(eval_forward(p, controls, pcof, order)[-1])
        if prev_final is not None:
            rel_errors.append(
                float(richardson_extrap_rel_err(final, prev_final, order)))
            if verbose:
                print(f"{res} steps/period: rel err {rel_errors[-1]:.3e}")
        prev_final = final
    return rel_errors
