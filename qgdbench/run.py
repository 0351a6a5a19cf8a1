"""Run one cell of the benchmark once, on the NVIDIA GPU of this machine:

    python3 qgdbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit; the same numbers end standard error.
Without a GPU, with fewer GPUs than the cell asks for, or where a JAX
module was loaded, it exits non-zero and prints no result.
"""

import os
import time


def _since_process_start() -> float:
    """Seconds since this process started (Linux; 0 where unknown)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS_START = time.perf_counter() - _since_process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels into ``qgd_tpu_torch/_build/``)."""
    cache = ROOT / ".qgdbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(cache / sub)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    # the checkout's root, not this script's folder, is where imports start
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]

    from qgdbench import harness

    spec = harness.load_cell(ROOT, args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"qgdbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no CPU fallback", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(
        spec, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_PROCESS_START)
    found = harness.forbidden_modules()
    if found:
        print(f"qgdbench: JAX modules loaded in the run: {found}",
              file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": chips, **result["device"],
                        "power_limit": _power_limit()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
