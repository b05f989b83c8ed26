"""ctypes binding to the host clustering kernels (`csrc/cluster.cpp`):
the average linkage and a float64 DTW of materialised pairs.

Counterpart of `ddiffpg_tpu/modes/_native.py`. The library is built with
`g++` at first use, from the source in this package only, into
`build/torch_ext/` at the root of the checkout (keyed by the source's
hash). Unlike the JAX package, which falls back to numpy when its library
is missing, a failed build or load raises: the recluster has no silent
second path.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

import numpy as np

from ddiffpg_tpu_torch.physics.substep_cuda import compile_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "cluster.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIB = None


def build() -> Path:
    """Compile the library (cached by the source's and the flags' hash);
    returns its path."""
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("no C++ compiler (g++) to build csrc/cluster.cpp")
    return compile_library(gxx, GXX_FLAGS, SOURCE, "cluster")


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.linkage_average.restype = ctypes.c_int
        lib.linkage_average.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double)]
        lib.dtw_batch.restype = ctypes.c_int
        lib.dtw_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double)]
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def linkage_average(dist: np.ndarray) -> np.ndarray:
    """dist [N, N] symmetric -> scipy-compatible Z [N-1, 4]."""
    lib = _load()
    n = dist.shape[0]
    if n < 2:
        return np.zeros((0, 4))
    d = np.ascontiguousarray(dist, np.float64)
    Z = np.zeros((n - 1, 4), np.float64)
    rc = lib.linkage_average(_ptr(d, ctypes.c_double), n,
                             _ptr(Z, ctypes.c_double))
    if rc != 0:
        raise RuntimeError(f"linkage_average failed rc={rc}")
    return Z


def dtw_batch(a: np.ndarray, b: np.ndarray, la: np.ndarray,
              lb: np.ndarray) -> np.ndarray:
    """DTW distances [P] of materialised pairs in float64 on the host:
    a, b [P, L, Dx], la, lb [P] valid lengths (dtaidistance's dtw_ndim:
    squared Euclidean cell cost, unconstrained warping)."""
    lib = _load()
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"a {a.shape} and b {b.shape}: want [P, L, Dx] "
                         "of one shape")
    P, Lmax, D = a.shape
    for name, n in (("la", la), ("lb", lb)):
        if np.shape(n) != (P,) or (P and not (
                0 <= np.min(n) and np.max(n) <= Lmax)):
            raise ValueError(f"{name}: want {P} lengths in 0..{Lmax}")
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    la = np.ascontiguousarray(la, np.int32)
    lb = np.ascontiguousarray(lb, np.int32)
    out = np.zeros(P, np.float64)
    rc = lib.dtw_batch(_ptr(a, ctypes.c_double), _ptr(b, ctypes.c_double),
                       _ptr(la, ctypes.c_int32), _ptr(lb, ctypes.c_int32),
                       P, Lmax, D, _ptr(out, ctypes.c_double))
    if rc != 0:
        raise RuntimeError(f"dtw_batch failed rc={rc}")
    return out
