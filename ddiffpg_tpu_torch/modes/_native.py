"""ctypes binding to the host linkage kernel (`csrc/cluster.cpp`).

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
        _LIB = lib
    return _LIB


def linkage_average(dist: np.ndarray) -> np.ndarray:
    """dist [N, N] symmetric -> scipy-compatible Z [N-1, 4]."""
    lib = _load()
    n = dist.shape[0]
    if n < 2:
        return np.zeros((0, 4))
    d = np.ascontiguousarray(dist, np.float64)
    Z = np.zeros((n - 1, 4), np.float64)
    ptr = lambda a: a.ctypes.data_as(  # noqa: E731
        ctypes.POINTER(ctypes.c_double))
    rc = lib.linkage_average(ptr(d), n, ptr(Z))
    if rc != 0:
        raise RuntimeError(f"linkage_average failed rc={rc}")
    return Z
