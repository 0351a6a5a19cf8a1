"""qgd_tpu_torch imports no JAX, pins full-precision float32 matmuls at
import, and its GPU smoke script refuses to run without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _run(code, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_pulls_in_no_jax_and_pins_precision():
    proc = _run(
        "import json, sys, torch\n"
        "import qgd_tpu_torch, qgd_tpu_torch.models, qgd_tpu_torch.ops\n"
        "print(json.dumps({\n"
        "  'jax': sorted(m for m in sys.modules\n"
        "               if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                                              'qgd_tpu.'))\n"
        "               or m == 'qgd_tpu'),\n"
        "  'tf32_matmul': torch.backends.cuda.matmul.allow_tf32,\n"
        "  'tf32_cudnn': torch.backends.cudnn.allow_tf32,\n"
        "  'precision': torch.get_float32_matmul_precision()}))\n")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"jax": [], "tf32_matmul": False, "tf32_cudnn": False,
                   "precision": "highest"}


def test_package_source_never_imports_jax():
    pkg = REPO / "qgd_tpu_torch"
    for path in pkg.rglob("*.py"):
        if path.relative_to(pkg).parts[0] == "_build":  # build outputs
            continue
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import qgd_tpu ", "from qgd_tpu ",
                                     "from qgd_tpu.", "import qgd_tpu.")), \
                f"{path}: {s}"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA here: the script exits non-zero and prints no result line;
    copied alone into an empty directory it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script runs there")
    for cwd in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if cwd == tmp_path:
            (tmp_path / "chip_smoke.py").write_text(script.read_text())
            script = tmp_path / "chip_smoke.py"
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
