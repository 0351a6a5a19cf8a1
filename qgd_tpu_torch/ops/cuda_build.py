"""Build and load the package's CUDA kernels (``qgd_tpu_torch/csrc``).

The sources have a plain C interface and include no PyTorch header, so
they compile with ``nvcc`` alone in seconds, one ``nvcc`` per source, all
started together, then linked into one library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c lhs.cu        # pair.cu, rhs.cu in parallel
    nvcc -shared -o libhermite_stage.so lhs.o pair.o rhs.o

The library is built at first use on a CUDA tensor, into
``qgd_tpu_torch/_build/<hash>/`` keyed by a hash of the sources, the
shared headers and the flags, and loaded with ``ctypes``. Nothing here
runs at import.
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
SOURCES = ("lhs.cu", "pair.cu", "rhs.cu")
HEADERS = ("stage_common.cuh", "lhs.cuh", "pair_tf32.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")
LIB_NAME = "libhermite_stage.so"
# what a kernel that cannot take a shape returns (csrc/stage_common.cuh)
SHAPE_REFUSED = -1

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
    for name in SOURCES + HEADERS:
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
    # build into temporary names, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    nvcc = _nvcc()
    objs = [tempfile.mkstemp(suffix=".o", dir=out_dir) for _ in SOURCES]
    for fd_o, _ in objs:
        os.close(fd_o)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                               str(CSRC / name)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for name, (_, obj) in zip(SOURCES, objs)]
    logs = [f"== {name}\n{p.communicate()[0]}"
            for name, p in zip(SOURCES, procs)]
    failed = [p.returncode for p in procs if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp,
                               *[obj for _, obj in objs]],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        failed = [link.returncode] if link.returncode != 0 else []
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    for _, obj in objs:
        os.unlink(obj)
    if failed:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds, "log": log,
            "cached": False}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process.
    Once loaded, a call returns it without taking the lock."""
    lib = _loaded.get("lib")
    if lib is not None:
        return lib
    with _lock:
        if "lib" in _loaded:
            return _loaded["lib"]
        info = build()
        lib = ctypes.CDLL(info["path"])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hermite_lhs_matrix_f32.argtypes = [p, p, f, f, p, p, p, i, i, i,
                                               p]
        lib.hermite_lhs_matrix_f32.restype = i
        lib.hermite_stage_pair_f32.argtypes = [p, p, f, p, p, p, p, i, i, i,
                                               p]
        lib.hermite_stage_pair_f32.restype = i
        lib.hermite_rhs_f32.argtypes = [p, p, f, f, p, p, p, p, i, i, i, i,
                                        p]
        lib.hermite_rhs_f32.restype = i
        lib.hermite_rhs_scratch_floats.argtypes = [i, i, i, i, i]
        lib.hermite_rhs_scratch_floats.restype = ctypes.c_longlong
        _loaded["lib"] = lib
        return lib
