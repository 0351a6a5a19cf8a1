"""The benchmark's files: every cell resolves by name, a cell added by
files and entries alone is found and runs, and no JAX module is loaded."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

from qgdbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    spec = harness.load_cell(ROOT, cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert {"batch", "nsteps", "start_fraction", "sample",
            "trace_calls"} <= set(spec["traffic"])
    assert set(spec["limits"]) == {"infidelity_rel", "guard_rel",
                                   "ridge_rel", "grad_rel", "nonfinite"}
    assert {m["name"] for m in spec["end_to_end"]} == {"steps_per_s",
                                                        "setup_s"}
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(harness.load_reader(ROOT, m["name"]))


def test_files_sit_under_paths():
    assert BENCH["paths"] == ["qgdbench"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("qgdbench/")
        assert (ROOT / c["file"]).is_file()
    for m in BENCH["per_layer"]:
        assert m["moves"] == "steps_per_s"
        assert set(m["workloads"]) <= set(CELLS)


def test_throwaway_cell_is_found_and_runs(tiny_root):
    spec = harness.load_cell(tiny_root, "tiny.small")
    assert spec["traffic"]["nsteps"] == 20
    result, checks = harness.run_cell(spec, 2 ** 31 + 7, 0.2, False, "cpu",
                                      0.0, log=lambda m: None)
    assert result["correct"], checks
    assert result["failed"] == 0
    assert result["attempted"] % 4 == 0 and result["attempted"] >= 4
    assert set(result["metrics"]) == {"steps_per_s", "setup_s"}
    assert list(checks) == ["infidelity_rel", "guard_rel", "ridge_rel",
                            "grad_rel", "nonfinite"]


def test_throwaway_cell_traced_run(tiny_root):
    """A traced run on the CPU reads no device: each device metric reads
    nothing, the harness leaves it out, and the check still holds."""
    spec = harness.load_cell(tiny_root, "tiny.small")
    result, _ = harness.run_cell(spec, 5, 0.1, True, "cpu", 0.0,
                                 log=lambda m: None)
    assert result["correct"]
    assert result["metrics"] == {}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs():
    spec = harness.load_cell(ROOT, CELLS[0])
    a = harness.Draw(spec, 180, 2 ** 32 + 3, "cpu")
    b = harness.Draw(spec, 180, 2 ** 32 + 3, "cpu")
    for _ in range(2):
        x, y = a(), b()
        assert (x == y).all()
        assert float(x.abs().max()) <= 0.002


def test_forbidden_modules_compares_whole_names():
    names = ["qgd_tpu_torch", "qgd_tpu_torch.ops", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(
        names + ["jax.numpy", "qgd_tpu.ops", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "qgd_tpu.ops"]


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from qgdbench import harness, program, calibrate; "
            "import qgd_tpu_torch; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is not reachable")
    out = subprocess.run(
        [sys.executable, str(ROOT / "qgdbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CPU fallback" in out.stderr
