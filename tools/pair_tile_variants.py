"""Time the four instantiations of the split-TF32 pair kernel
(``qgd_tpu_torch/csrc/pair_tf32.cuh``: output tile kT in {32, 64}, and
the body specialised for n = 128 or the general one) against one another
on the card, at n = 128 and the batches where the launcher's choice
matters. Needs a CUDA card and ``nvcc``; imports no JAX.

    python3 tools/pair_tile_variants.py [--batches 1,8,32,33,100,256,999]

It compiles one small source that includes the kernel header and calls
each instantiation's launcher directly (into ``qgd_tpu_torch/_build/``),
checks that every variant returns the same (R, L) as the package's
wrapper, and prints one JSON line per batch: the device time per call of
each variant (a CUDA graph of back-to-back calls, the median of 10
CUDA-event-timed replays, the variants timed in order and again in
reverse, the two times averaged), beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qgd_tpu_torch.ops import cuda_build  # noqa: E402
from qgd_tpu_torch.ops import stage_kernels as sk  # noqa: E402

VARIANTS = ((64, 1), (64, 0), (32, 1), (32, 0))  # (kT, kFull)
N = 128

SOURCE = r"""
#include "pair_tf32.cuh"

extern "C" int pair_tf32_variant(int kt, int full, const float* a,
                                 const float* dt, float* out_r,
                                 float* out_l, const float* coeffs_host,
                                 int batch, int n, void* stream) {
  const hermite::Coeffs c = hermite::make_coeffs(coeffs_host, 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace tf32_pair;
  cudaError_t e;
  if (kt == 64)
    e = full ? launch<64, true>(a, dt, 0.f, out_r, out_l, c, batch, n, st)
             : launch<64, false>(a, dt, 0.f, out_r, out_l, c, batch, n, st);
  else
    e = full ? launch<32, true>(a, dt, 0.f, out_r, out_l, c, batch, n, st)
             : launch<32, false>(a, dt, 0.f, out_r, out_l, c, batch, n, st);
  return static_cast<int>(e);
}
"""


def _key(kt: int, full: int) -> str:
    return f"{kt}x{kt} {'n=128 body' if full else 'general body'}"


def build() -> ctypes.CDLL:
    out = cuda_build.BUILD_ROOT / "pair_tile_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "variants.cu"
    src.write_text(SOURCE)
    lib = out / "libvariants.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
                    "-I", str(cuda_build.CSRC), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def device_ms(fn, calls: int, reps: int = 10) -> float:
    """Device time of one ``fn()`` (ms): a CUDA graph of ``calls`` calls,
    the median of ``reps`` CUDA-event-timed replays over ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="1,8,32,33,100,256,999")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    lib = build()
    coeffs = sk._coeffs_arg(2)
    dev = torch.device("cuda")
    dt = torch.tensor(0.55, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    for B in (int(b) for b in args.batches.split(",")):
        A = torch.tensor(rng.standard_normal((B, 2, N, N)),
                         dtype=torch.float32, device=dev)
        R, L = (torch.empty((B, N, N), dtype=torch.float32, device=dev)
                for _ in "RL")

        def launcher(kt, full):
            def fn():
                err = lib.pair_tf32_variant(
                    kt, full, ctypes.c_void_p(A.data_ptr()),
                    ctypes.c_void_p(dt.data_ptr()),
                    ctypes.c_void_p(R.data_ptr()),
                    ctypes.c_void_p(L.data_ptr()), coeffs, B, N,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError(f"launch failed ({err})")
            return fn

        Rw, Lw = sk.hermite_stage_pair_kernel_call(A, dt, 2)
        same = {}
        for kt, full in VARIANTS:
            launcher(kt, full)()
            torch.cuda.synchronize()
            same[_key(kt, full)] = float(max((R - Rw).abs().max(),
                                             (L - Lw).abs().max()))
        calls = 20 if B <= 1000 else 3
        ms = {_key(kt, full): [] for kt, full in VARIANTS}
        for order in (VARIANTS, VARIANTS[::-1]):
            for kt, full in order:
                ms[_key(kt, full)].append(device_ms(launcher(kt, full),
                                                    calls))
        print(json.dumps({
            "B": B, "n": N,
            "ms": {k: float(np.mean(v)) for k, v in ms.items()},
            "ms_each_order": ms,
            "max_abs_diff_vs_wrapper": same, "smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
