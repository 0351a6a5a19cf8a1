"""Plotting utilities (counterpart of ``qgd_tpu.utils.plotting``; the
reference's ``src/plotting.jl``).

Each function draws with matplotlib's Agg backend unless another is set
and returns the Figure. matplotlib is imported on use only: the package
needs it for nothing else.
"""

from __future__ import annotations

import numpy as np
import torch


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    return torch.as_tensor(x).detach().cpu().numpy()


def plot_controls(controls, pcof, *, derivative_orders=(0,), npoints=1001,
                  convert_units=False, ax=None):
    """p/q pulse envelopes (and time derivatives) over ``[0, tf]``."""
    from ..controls import (as_control_tuple, control_vector_slice,
                            eval_p_derivative, eval_q_derivative)

    plt = _plt()
    controls = as_control_tuple(controls)
    pcof = torch.as_tensor(pcof, dtype=torch.float64)
    fig, axes = plt.subplots(len(derivative_orders), 1, squeeze=False)
    tf = controls[0].tf
    ts = np.linspace(0, tf, npoints)
    scale = 1e3 / (2 * np.pi) if convert_units else 1.0  # rad/ns -> MHz
    for row, order in enumerate(derivative_orders):
        a = axes[row][0]
        for i, ctrl in enumerate(controls):
            local = control_vector_slice(pcof, controls, i)
            p = [float(eval_p_derivative(ctrl, t, local, order)) for t in ts]
            q = [float(eval_q_derivative(ctrl, t, local, order)) for t in ts]
            a.plot(ts, np.asarray(p) * scale, label=f"p{i}^({order})")
            a.plot(ts, np.asarray(q) * scale, label=f"q{i}^({order})",
                   linestyle="--")
        a.set_xlabel("t")
        a.set_ylabel("MHz" if convert_units else "amplitude")
        a.legend(fontsize=6)
    return fig


def plot_populations(history, ts=None, ax=None, labels=None):
    """Per-level populations over time; ``history`` is time-major ``(T,
    2N, B)``."""
    from .states import get_populations

    plt = _plt()
    pops = _np(get_populations(history))
    T, N, B = pops.shape
    if ts is None:
        ts = np.arange(T)
    fig, axes = plt.subplots(1, B, squeeze=False, sharey=True)
    for b in range(B):
        a = axes[0][b]
        for lev in range(N):
            a.plot(ts, pops[:, lev, b],
                   label=(labels[lev] if labels else f"|{lev}>"))
        a.set_xlabel("t")
        a.set_title(f"IC {b}")
    axes[0][0].set_ylabel("population")
    axes[0][-1].legend(fontsize=6)
    return fig


def plot_states(history, ts=None):
    """Real and imaginary state components over time."""
    plt = _plt()
    hist = _np(history)
    if hist.ndim == 4:
        hist = hist[:, 0]
    T, two_n, B = hist.shape
    n = two_n // 2
    if ts is None:
        ts = np.arange(T)
    fig, axes = plt.subplots(2, B, squeeze=False, sharex=True)
    for b in range(B):
        for lev in range(n):
            axes[0][b].plot(ts, hist[:, lev, b])
            axes[1][b].plot(ts, hist[:, n + lev, b])
        axes[0][b].set_title(f"IC {b}")
    axes[0][0].set_ylabel("Re")
    axes[1][0].set_ylabel("Im")
    return fig


def plot_gradient_agreement(prob, controls, target, *, order=4, n_samples=5,
                            amplitude=0.5, seed=0):
    """Scatter the adjoint, forced and finite-difference gradients against
    each other over random control vectors; returns ``(fig,
    max_pairwise_deviation)``."""
    from ..adjoint import (discrete_adjoint, eval_grad_finite_difference,
                           eval_grad_forced)
    from ..controls import as_control_tuple, total_control_parameters

    plt = _plt()
    controls = as_control_tuple(controls)
    n = total_control_parameters(controls)
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_samples):
        pcof = rng.uniform(-amplitude, amplitude, n)
        rows.append(tuple(_np(fn(prob, controls, pcof, target, order))
                          for fn in (discrete_adjoint, eval_grad_forced,
                                     eval_grad_finite_difference)))
    fig, ax = plt.subplots()
    dev = 0.0
    for g_adj, g_for, g_fd in rows:
        ax.scatter(g_fd, g_adj, marker="o", s=12, label=None)
        ax.scatter(g_fd, g_for, marker="x", s=12, label=None)
        dev = max(dev, float(np.abs(g_adj - g_for).max()),
                  float(np.abs(g_adj - g_fd).max()))
    lims = ax.get_xlim()
    ax.plot(lims, lims, "k--", linewidth=0.5)
    ax.set_xlabel("finite-difference gradient")
    ax.set_ylabel("adjoint (o) / forced (x) gradient")
    return fig, dev


def plot_control_basis_functions(control, *, npoints=501):
    """Each basis function of a linear control (one unit entry of its
    control vector at a time)."""
    from ..controls import eval_p

    plt = _plt()
    ts = np.linspace(0, control.tf, npoints)
    fig, ax = plt.subplots()
    for i in range(control.N_coeff // 2):
        pc = torch.zeros(control.N_coeff, dtype=torch.float64)
        pc[i] = 1.0
        ax.plot(ts, [float(eval_p(control, t, pc)) for t in ts],
                label=f"B{i}")
    ax.set_xlabel("t")
    return fig


def plot_convergence(results, *, target_error=1e-7, x="dt"):
    """Log-log Richardson error against dt or against runtime, from a
    ``get_histories`` result."""
    plt = _plt()
    fig, ax = plt.subplots()
    for key, entry in results.items():
        errs = entry["rel_errs"]
        if not errs:
            continue
        if x == "dt":
            xs = [1.0 / n for n in entry["nsteps"][1:]]
            ax.set_xlabel("dt (arb)")
        else:
            xs = entry["elapsed"][1:]
            ax.set_xlabel("runtime (s)")
        ax.loglog(xs, errs, "o-", label=key)
    ax.axhline(target_error, color="k", linestyle="--", linewidth=0.5)
    ax.set_ylabel("Richardson relative error")
    ax.legend(fontsize=7)
    return fig
