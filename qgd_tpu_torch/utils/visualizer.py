"""Interactive control visualizer (counterpart of
``qgd_tpu.utils.visualizer``; the reference's GLMakie
``ControlVisualizer`` extension): one slider per control-vector entry,
live control-envelope and population plots.

Needs an interactive matplotlib backend (notebook, Qt); a headless run
uses :func:`visualize_control_grid`, a static panel sweep. matplotlib is
imported on use only.
"""

from __future__ import annotations

import numpy as np
import torch


def _populations(prob, controls, pc, order):
    from ..forward import eval_forward
    from .states import get_populations

    hist = eval_forward(prob, controls, pc, order)
    return get_populations(hist).detach().cpu().numpy()


def visualize_control(prob, controls, pcof0, *, order=4, npoints=201,
                      slider_range=1.0):
    """A matplotlib slider dashboard over the control-vector entries (the
    first 16) that redraws the control envelopes and the populations on
    change; returns ``(fig, sliders)``."""
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider

    from ..controls import (as_control_tuple, control_vector_slice, eval_p,
                            eval_q)

    controls = as_control_tuple(controls)
    pcof0 = np.asarray(pcof0, dtype=np.float64)
    n = pcof0.size
    ts = np.linspace(0, float(prob.tf), npoints)

    fig = plt.figure(figsize=(10, 6))
    ax_ctrl = fig.add_axes([0.35, 0.55, 0.6, 0.4])
    ax_pop = fig.add_axes([0.35, 0.08, 0.6, 0.4])

    sliders = []
    for i in range(min(n, 16)):
        ax_s = fig.add_axes([0.05, 0.9 - i * 0.055, 0.2, 0.03])
        sliders.append(Slider(ax_s, f"p{i}", pcof0[i] - slider_range,
                              pcof0[i] + slider_range, valinit=pcof0[i]))

    def redraw(_=None):
        pc = pcof0.copy()
        for i, s in enumerate(sliders):
            pc[i] = s.val
        pct = torch.as_tensor(pc)
        ax_ctrl.clear()
        for ci, ctrl in enumerate(controls):
            local = control_vector_slice(pct, controls, ci)
            ax_ctrl.plot(ts, [float(eval_p(ctrl, t, local)) for t in ts],
                         label=f"p{ci}")
            ax_ctrl.plot(ts, [float(eval_q(ctrl, t, local)) for t in ts],
                         "--", label=f"q{ci}")
        ax_ctrl.legend(fontsize=6)
        pops = _populations(prob, controls, pct, order)
        ax_pop.clear()
        for lev in range(pops.shape[1]):
            ax_pop.plot(pops[:, lev, 0], label=f"|{lev}>")
        ax_pop.legend(fontsize=6)
        fig.canvas.draw_idle()

    for s in sliders:
        s.on_changed(redraw)
    redraw()
    return fig, sliders


def visualize_control_grid(prob, controls, pcof0, *, param_index=0,
                           values=None, order=4):
    """Headless variant: sweep entry ``param_index`` over ``values`` and
    draw a panel of (controls, populations) per value; returns the
    Figure."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    from ..controls import as_control_tuple, control_vector_slice, eval_p

    controls = as_control_tuple(controls)
    pcof0 = np.asarray(pcof0, dtype=np.float64)
    if values is None:
        v0 = pcof0[param_index]
        values = [v0 - 0.5, v0, v0 + 0.5]
    ts = np.linspace(0, float(prob.tf), 101)
    fig, axes = plt.subplots(2, len(values), squeeze=False, figsize=(9, 5))
    for col, val in enumerate(values):
        pc = pcof0.copy()
        pc[param_index] = val
        pct = torch.as_tensor(pc)
        for ci, ctrl in enumerate(controls):
            local = control_vector_slice(pct, controls, ci)
            axes[0][col].plot(ts, [float(eval_p(ctrl, t, local))
                                   for t in ts])
        pops = _populations(prob, controls, pct, order)
        for lev in range(pops.shape[1]):
            axes[1][col].plot(pops[:, lev, 0])
        axes[0][col].set_title(f"pcof[{param_index}]={val:.3g}", fontsize=8)
    return fig
