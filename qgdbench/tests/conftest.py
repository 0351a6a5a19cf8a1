"""Helpers of the benchmark's CPU tests: the checkout's root on the import
path, and a copy of the benchmark with a throwaway cell added by files
and entries alone.

Run from the root of the checkout: ``python -m pytest qgdbench/tests``.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a cut of the first cell small enough for the CPU: 20 steps of 0.55 ns,
# 4 control vectors per call, every answer compared, L = 1 as the first
# cell runs on the card
TINY = {"config": "cnot3_o4", "limits_of": "cnot3_o4.batch256",
        "tf_ns": 11.0, "traffic": {"batch": 4, "nsteps": 20,
                                   "n_segments": 20, "start_fraction": 0.1,
                                   "sample": 64, "trace_calls": 1}}


def make_root(tmp_path: Path, tiny=TINY) -> Path:
    """A copy of the benchmark under ``tmp_path`` with the cell
    ``tiny.small`` added: a new configuration file, traffic file and
    limits file, and entries in ``BENCHMARK.json``; no file of the copy
    is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "qgdbench", root / "qgdbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "qgdbench" / "configs"
                      / f"{tiny['config']}.json").read_text())
    cfg.update(name="tiny", tf_ns=tiny["tf_ns"])
    (root / "qgdbench" / "configs" / "tiny.json").write_text(
        json.dumps(cfg))
    (root / "qgdbench" / "traffic" / "small.json").write_text(
        json.dumps(tiny["traffic"]))
    shutil.copy(ROOT / "qgdbench" / "limits" / f"{tiny['limits_of']}.json",
                root / "qgdbench" / "limits" / "tiny.small.json")
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "qgdbench/configs/tiny.json",
                             "reduced": ["tf_ns"], "why": "a test"})
    bench["workloads"].append({"name": "tiny.small", "config": "tiny",
                               "traffic": "small", "chips": 1,
                               "why": "a test"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append("tiny.small")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
