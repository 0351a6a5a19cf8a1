"""The plain reference: its float64 gradient against finite differences,
its numbers against the program's float64 route, and the roofline's
count of the stage build against a count worked by hand."""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT

from qgdbench import harness, system
from qgdbench.reference.hermite import Reference


def _tiny_config(order):
    """Two transmons of 3 levels, 2 essential each, 4 B-spline
    coefficients per quadrature and 2 carriers: 32 parameters."""
    return {"system": {"subsystem_sizes": [3, 3], "essential_sizes": [2, 2],
                       "transition_freqs_GHz": [4.1, 4.8],
                       "rotation_freqs_GHz": [4.1, 4.8],
                       "kerr_GHz": [[0.22, 0.01], [0.01, 0.23]]},
            "gate": {"name": "CNOT", "control_qudit": 0, "target_qudit": 1,
                     "rotating_frame": True},
            "tf_ns": 2.2, "order": order, "ridge": 0.01,
            "controls": {"D1": 4, "carrier_freqs_GHz": [[0.0, -0.01],
                                                        [0.0, -0.01]]}}


@pytest.mark.parametrize("order", [4, 8])
def test_reference_gradient_matches_finite_differences(order):
    inputs = system.build_inputs(_tiny_config(order))
    ref = Reference(inputs, order, 4, 0.01, "cpu")
    pcof = np.random.default_rng(order).uniform(-0.5, 0.5, (1, 32))
    grad = ref.evaluate(pcof)["grad"][0]

    def total(p):
        r = ref.evaluate(p[None])
        return r["infidelity"][0] + r["guard"][0] + r["ridge"][0]

    h = 1e-6
    fd = np.array([(total(pcof[0] + h * e) - total(pcof[0] - h * e))
                   / (2 * h) for e in np.eye(32)])
    assert np.linalg.norm(fd - grad) <= 1e-7 * np.linalg.norm(grad)


@pytest.mark.parametrize("order", [4, 8])
def test_reference_matches_the_programs_float64_route(order):
    """The program's float64 LU route computes the same discrete objective
    and its exact gradient: they agree to roundoff."""
    from qgdbench.program import Program

    cfg = json.loads((ROOT / "qgdbench" / "configs"
                      / f"cnot3_o{order}.json").read_text())
    # 20 steps of 0.55 ns; at order 8 the knot at 137.5 / 8 ns is a grid
    # point, where the B-spline's second derivative jumps
    cfg["tf_ns"] = 11.0 if order == 4 else 137.5
    nsteps = 20 if order == 4 else 250
    cfg["precision"] = dict(cfg["precision"], dtype="float64", solver="lu")
    inputs = system.build_inputs(cfg)
    pcof = torch.tensor(np.random.default_rng(1).uniform(-0.02, 0.02,
                                                         (2, 180)))
    out = Program(cfg, {"nsteps": nsteps}, inputs, "cpu").call(pcof)
    out = {k: v.numpy() for k, v in out.items()}
    ref = Reference(inputs, order, nsteps, cfg["ridge"], "cpu").evaluate(pcof)
    for k, v in harness.compare(out, ref).items():
        assert np.max(v) <= 1e-12, (k, v)


def test_stage_build_counts_by_hand():
    roof = harness.load_reader  # the reader's module holds the counts
    import importlib.util

    path = ROOT / "qgdbench" / "metrics" / "stage_kernels_roofline.py"
    spec = importlib.util.spec_from_file_location("roof", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    n, b = 128, 8
    # m = 2: D_2 = (A_1 + A_0 A_0) / 2, one 128^3 product; the stack (2
    # matrices) in, one matrix out (LHS) or two (pair); the explicit half
    # A_0 w, A_1 w + A_0 (A_0 w): 3 products of 128 x 128 by 128 x 8
    assert mod.lhs_work(n, 2) == (2 * 128 ** 3, 4 * 3 * 128 * 128)
    assert mod.pair_work(n, 2) == (2 * 128 ** 3, 4 * 4 * 128 * 128)
    assert mod.rhs_work(n, 2, b) == (3 * 2 * 128 * 128 * 8,
                                     4 * (2 * 128 * 128 + 2 * 128 * 8))
    # m = 4: D_2, D_3, D_4 take 1 + 2 + 3 products; the explicit half
    # 1 + 2 + 3 + 4
    assert mod.lhs_work(n, 4) == (6 * 2 * 128 ** 3, 4 * 5 * 128 * 128)
    assert mod.pair_work(n, 4) == (6 * 2 * 128 ** 3, 4 * 6 * 128 * 128)
    assert mod.rhs_work(n, 4, b) == (10 * 2 * 128 * 128 * 8,
                                     4 * (4 * 128 * 128 + 2 * 128 * 8))
    # every part of the main path's build is bound by HBM bytes
    assert mod.step_bound_s(n, 2, b) == pytest.approx(
        4 * (3 + 4) * 128 * 128 / 3.35e12
        + 4 * (2 * 128 * 128 + 2 * 128 * 8) / 3.35e12)
    ctx = {"calls": 2, "nsteps": 10, "batch": 4, "n": n, "m": 2, "b": b,
           "device_ops": [("sm80_xmma_gemm", 0, 10 ** 6)]}
    assert mod.read(ctx) is None            # no stage kernel traced
    bound = 2 * 10 * 4 * mod.step_bound_s(n, 2, b)
    ctx["device_ops"].append(("void lhs_staged_kernel<true>", 0,
                              round(4 * bound * 1e9)))
    assert mod.read(ctx) == pytest.approx(25.0, rel=1e-4)
    assert roof(ROOT, "stage_kernels.device_share")(ctx) == pytest.approx(
        4 * bound * 1e9 / (4 * bound * 1e9 + 10 ** 6), rel=1e-4)
