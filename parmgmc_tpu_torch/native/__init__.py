"""ctypes loader of the native graph set-up (``graph_setup.cpp``).

:func:`lib` compiles ``graph_setup.cpp`` with the host C++ compiler at
first use into ``build/parmgmc_tpu_torch/`` at the root of the checkout,
beside the CUDA kernels' library, and rebuilds it when the source is
newer.  A failed build raises with the compiler's output: the set-up
does not fall back to the Python loops silently.  The Python loops
(:func:`parmgmc_tpu_torch.operators.graph.greedy_coloring_py`,
:func:`parmgmc_tpu_torch.operators.aggregation.aggregate_py`,
:func:`parmgmc_tpu_torch.operators.graph.ell_pack_py`) are the twins,
equal bit for bit; the tests hold the two against each other.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

__all__ = ["lib", "greedy_coloring", "aggregate", "ell_pack"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "graph_setup.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "parmgmc_tpu_torch")
_SO = os.path.join(BUILD_DIR, "libgraph_setup.so")

_LOCK = threading.Lock()
_LIB = None


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no host C++ compiler (g++, c++ or clang++) for the native graph set-up")


def build() -> None:
    """Compile the library if it is missing or older than its source.  The
    object is written to a temporary file and renamed into place, so
    processes that build at once never load a partial file."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, os.path.basename(_SO))
        res = subprocess.run([_compiler(), "-O3", "-shared", "-fPIC", "-o", so, _SRC],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {_SRC} failed:\n{res.stdout}")
        os.replace(so, _SO)


def lib() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            L = ctypes.CDLL(_SO)
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            f64p = ctypes.POINTER(ctypes.c_double)
            L.pmg_greedy_coloring.restype = ctypes.c_int32
            L.pmg_greedy_coloring.argtypes = [ctypes.c_int64, i64p, i32p, i32p]
            L.pmg_aggregate.restype = ctypes.c_int64
            L.pmg_aggregate.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
            L.pmg_ell_pack.restype = None
            L.pmg_ell_pack.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p, f64p, f64p, i32p]
            _LIB = L
        return _LIB


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _csr(indptr, indices):
    return (np.ascontiguousarray(indptr, dtype=np.int64),
            np.ascontiguousarray(indices, dtype=np.int32))


def greedy_coloring(indptr, indices, n: int) -> np.ndarray:
    """Greedy distance-1 colouring in natural order: (n,) int32 colours."""
    L = lib()
    indptr, indices = _csr(indptr, indices)
    colors = np.empty(n, dtype=np.int32)
    L.pmg_greedy_coloring(n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
                          _ptr(colors, ctypes.c_int32))
    return colors


def aggregate(indptr, indices, n: int):
    """(agg (n,) int64, n_agg): greedy MIS-style aggregation of a strength
    graph."""
    L = lib()
    indptr, indices = _csr(indptr, indices)
    agg = np.empty(n, dtype=np.int64)
    n_agg = L.pmg_aggregate(n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
                            _ptr(agg, ctypes.c_int64))
    return agg, int(n_agg)


def ell_pack(indptr, indices, data, n: int, w: int):
    """(vals (n, w) float64, cols (n, w) int32): the CSR rows packed to
    width w, values zero-padded, columns padded with the row index."""
    L = lib()
    indptr, indices = _csr(indptr, indices)
    data = np.ascontiguousarray(data, dtype=np.float64)
    vals = np.empty((n, w), dtype=np.float64)
    cols = np.empty((n, w), dtype=np.int32)
    L.pmg_ell_pack(n, w, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
                   _ptr(data, ctypes.c_double), _ptr(vals, ctypes.c_double), _ptr(cols, ctypes.c_int32))
    return vals, cols
