"""The system under test: ``qgd_tpu_torch``'s batched objective + exact
discrete-adjoint gradient, ``segmented_objective_and_gradient``, the call
``optimize_gate_multistart(gradient_route="segmented")`` makes at each
iteration. The program is built from the arrays of
:func:`qgdbench.system.build_inputs` and a configuration's precision
settings; one ``SegmentGraphs`` keeps its captured step programs for the
whole run."""

from __future__ import annotations

import numpy as np


class Program:
    """``call(pcof (S, N_params) float64 tensor)`` -> ``{"infidelity",
    "guard", "ridge" (S,), "grad" (S, N_params)}`` float64 tensors on the
    device."""

    def __init__(self, config: dict, traffic: dict, inputs: dict, device):
        import qgd_tpu_torch as qt

        self._qt = qt
        prec = config["precision"]
        H0 = inputs["H0"]
        u0 = inputs["u0"]
        self.prob = qt.schrodinger_problem(
            H0.real, H0.imag, inputs["sym_ops"], inputs["asym_ops"], u0,
            np.zeros_like(u0), inputs["tf"], traffic["nsteps"],
            inputs["N_ess"], inputs["guard"], solver=prec["solver"],
            schulz_iters=prec["schulz_iters"],
            schulz_warm_budget=prec["schulz_warm_budget"],
            dtype=prec["dtype"], device=device)
        self.controls = [
            qt.CarrierControl(qt.BSpline2Control(inputs["D1"], inputs["tf"]),
                              freqs)
            for freqs in inputs["carrier_freqs"]]
        self.target = inputs["target"]
        self.order = int(config["order"])
        self.ridge = float(config["ridge"])
        self.sweeps = int(prec["refine_sweeps"])
        self.n_segments = int(traffic.get("n_segments", 0))
        self.graphs = qt.SegmentGraphs()

    def call(self, pcof) -> dict:
        (j1, guard, ridge), grad = self._qt.segmented_objective_and_gradient(
            self.prob, self.controls, pcof, self.target, self.order,
            ridge_penalty_strength=self.ridge, n_segments=self.n_segments,
            refine_sweeps=self.sweeps, graphs=self.graphs)
        return {"infidelity": j1, "guard": guard, "ridge": ridge,
                "grad": grad}

    def stats(self) -> dict:
        """Graphs captured, capture seconds and replays (not a metric)."""
        return self.graphs.stats()
