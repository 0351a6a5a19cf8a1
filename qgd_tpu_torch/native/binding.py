"""ctypes binding of the port's native de Boor library (``bsplvd.cc``),
built with ``g++`` at first use into ``qgd_tpu_torch/_build/``, keyed by a
hash of the source and the flags; no binary is kept in the source tree.
A failed build raises; :func:`native_available` is false only where there
is no ``g++``."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "bsplvd.cc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _compiler():
    return shutil.which("g++")


def build_library() -> str:
    """Compile ``bsplvd.cc`` unless an up-to-date build exists; returns the
    library's path. The build goes to a temporary name and is renamed
    into place, so concurrent builds never load a half-written file."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    lib = _BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libqgd_bspline.so"
    if lib.exists():
        return str(lib)
    gxx = _compiler()
    if gxx is None:
        raise RuntimeError("g++ not found: the native de Boor library is "
                           "built at first use")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    proc = subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return str(lib)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            d, i64 = ctypes.POINTER(ctypes.c_double), ctypes.c_int64
            lib.qgd_bsplvb.argtypes = [d, i64, ctypes.c_double, i64, d]
            lib.qgd_bsplvb.restype = None
            lib.qgd_bsplvd.argtypes = [d, i64, ctypes.c_double, i64, d, i64]
            lib.qgd_bsplvd.restype = None
            lib.qgd_bspline_tables.argtypes = [d, i64, i64, d, i64, i64, d,
                                               ctypes.POINTER(i64)]
            lib.qgd_bspline_tables.restype = None
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library can be used here: false where there is no
    ``g++``; otherwise it is built (a failed build raises) and true."""
    if _lib is None and _compiler() is None:
        return False
    _load()
    return True


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _knots(knots, k: int, lo: int, hi: int):
    """The knots as contiguous float64, checked to hold indices
    ``lo..hi``, the ones the routine reads."""
    knots = np.ascontiguousarray(knots, dtype=np.float64)
    if k < 1 or lo < 0 or hi >= knots.size:
        raise ValueError(f"order k={k} reads knots {lo}..{hi} of "
                         f"{knots.size}")
    return knots


def bsplvb(knots, k: int, x: float, left: int) -> np.ndarray:
    """Values of the ``k`` non-vanishing order-``k`` B-splines at ``x``
    (0-based ``left``: ``t[left] <= x < t[left+1]``)."""
    lib = _load()
    knots = _knots(knots, k, left - k + 2 if k > 1 else left,
                   left + k - 1 if k > 1 else left)
    out = np.zeros(k)
    lib.qgd_bsplvb(_dptr(knots), k, float(x), int(left), _dptr(out))
    return out


def bsplvd(knots, k: int, x: float, left: int, nderiv: int) -> np.ndarray:
    """``(k, nderiv)``: entry ``(i, m)`` is the m-th derivative of the i-th
    non-vanishing order-``k`` B-spline at ``x``."""
    lib = _load()
    nderiv = max(1, min(int(nderiv), k))
    if nderiv > 1:
        knots = _knots(knots, k, left - k + 1, left + k)
    else:
        knots = _knots(knots, k, left - k + 2 if k > 1 else left,
                       left + k - 1 if k > 1 else left)
    out = np.zeros((nderiv, k))
    lib.qgd_bsplvd(_dptr(knots), k, float(x), int(left), _dptr(out),
                   nderiv)
    return out.T.copy()


def bspline_tables(knots, k: int, n_distinct: int, xs, nderiv: int):
    """Basis tables over the points ``xs`` in [0, 1]: ``(values (n_x,
    nderiv, k), offsets (n_x,))``, offset = first coefficient index."""
    lib = _load()
    knots = np.ascontiguousarray(knots, dtype=np.float64)
    if knots.size != 2 * (k - 1) + n_distinct:
        raise ValueError(f"{knots.size} knots for order {k} with "
                         f"{n_distinct} distinct knots")
    xs = np.ascontiguousarray(xs, dtype=np.float64)
    nderiv = max(1, min(int(nderiv), k))
    out = np.zeros((xs.shape[0], nderiv, k))
    offsets = np.zeros(xs.shape[0], dtype=np.int64)
    lib.qgd_bspline_tables(
        _dptr(knots), int(k), int(n_distinct), _dptr(xs), xs.shape[0],
        nderiv, _dptr(out),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out, offsets
