"""Build and load the package's CUDA kernels (``qgd_tpu_torch/csrc``).

The sources have a plain C interface and include no PyTorch header, so
they compile with ``nvcc`` alone in seconds::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o libhermite_stage.so hermite_stage.cu

The library is built at first use on a CUDA tensor, into
``qgd_tpu_torch/_build/<hash>/`` keyed by a hash of the sources and flags,
and loaded with ``ctypes``. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("hermite_stage.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libhermite_stage.so"

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built at first use and "
            "need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels unless an up-to-date build exists. Returns
    ``{"path", "seconds", "log", "cached"}``; ``log`` holds nvcc's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    out_dir = _build_dir()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(lib), "seconds": 0.0, "log": log, "cached": True}
    out_dir.mkdir(parents=True, exist_ok=True)
    # build into a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(CSRC / name) for name in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds, "log": log,
            "cached": False}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    with _lock:
        if "lib" in _loaded:
            return _loaded["lib"]
        info = build()
        lib = ctypes.CDLL(info["path"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hermite_lhs_matrix_f32.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.hermite_lhs_matrix_f32.restype = i
        lib.hermite_rhs_f32.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.hermite_rhs_f32.restype = i
        lib.hermite_stage_max_levels.argtypes = []
        lib.hermite_stage_max_levels.restype = i
        _loaded["lib"] = lib
        return lib
