"""ctypes loaders of the native host code: the graph set-up
(``graph_setup.cpp``) and the CPU anchor (``ref_sor_bench.cpp``).

:func:`lib` compiles ``graph_setup.cpp`` with the host C++ compiler at
first use into ``build/parmgmc_tpu_torch/`` at the root of the checkout,
beside the CUDA kernels' library, and rebuilds it when the source is
newer.  A failed build raises with the compiler's output: the set-up
does not fall back to the Python loops silently.  The Python loops
(:func:`parmgmc_tpu_torch.operators.graph.greedy_coloring_py`,
:func:`parmgmc_tpu_torch.operators.aggregation.aggregate_py`,
:func:`parmgmc_tpu_torch.operators.graph.ell_pack_py`) are the twins,
equal bit for bit; the tests hold the two against each other.

:func:`ref_sor_bench` and :func:`ref_sor_bench_csr` time the
reference's CSR red/black (multicolour) SOR loop on one host core, the
anchor of ``examples/baseline_cpu_reference.py`` and of
``examples/benchmark_matern.py --anchor-ranks``; ``ref_sor_bench.cpp``
builds the same way, into ``libref_sor_bench.so``, and a failed build
raises likewise.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

__all__ = ["lib", "greedy_coloring", "aggregate", "ell_pack", "ref_sor_bench", "ref_sor_bench_csr"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "graph_setup.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "parmgmc_tpu_torch")
_SO = os.path.join(BUILD_DIR, "libgraph_setup.so")
_SOR_SRC = os.path.join(_DIR, "ref_sor_bench.cpp")
_SOR_SO = os.path.join(BUILD_DIR, "libref_sor_bench.so")

_LOCK = threading.Lock()
_LIB = None
_SOR_LIB = None


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no host C++ compiler (g++, c++ or clang++) for the native host code")


def _compile(src: str, so_path: str) -> None:
    """Compile ``src`` into ``so_path`` if it is missing or older than its
    source.  The object is written to a temporary file and renamed into
    place, so processes that build at once never load a partial file."""
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(src):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, os.path.basename(so_path))
        res = subprocess.run([_compiler(), "-O3", "-shared", "-fPIC", "-o", so, src],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {src} failed:\n{res.stdout}")
        os.replace(so, so_path)


def build() -> None:
    """Compile the graph set-up library if it is missing or out of date."""
    _compile(_SRC, _SO)


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


def sor_lib() -> ctypes.CDLL:
    """The loaded CPU-anchor library (built on first use)."""
    global _SOR_LIB
    with _LOCK:
        if _SOR_LIB is None:
            _compile(_SOR_SRC, _SOR_SO)
            L = ctypes.CDLL(_SOR_SO)
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            f64p = ctypes.POINTER(ctypes.c_double)
            L.pmg_ref_sor_bench.restype = ctypes.c_int64
            L.pmg_ref_sor_bench.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                                            ctypes.c_double, f64p, f64p]
            L.pmg_ref_sor_bench_csr.restype = ctypes.c_int64
            L.pmg_ref_sor_bench_csr.argtypes = [ctypes.c_int64, i64p, i32p, f64p, f64p, ctypes.c_int64,
                                                ctypes.c_double, f64p, f64p]
            _SOR_LIB = L
        return _SOR_LIB


def ref_sor_bench(n: int, nsweeps: int = 8, kappa2: float = 1.0, omega: float = 1.0):
    """(n_dof, sec_per_sweep, sec_per_noise_fill): the reference's CSR
    red/black SOR sweep of the 7-point shifted Laplacian on an n^3 grid in
    float64, and its N(0, 1) fill of one vector (Box-Muller), timed on one
    host core over ``nsweeps`` repetitions (unit-domain FD scaling, hinv2
    = (n + 1)^2)."""
    L = sor_lib()
    hinv2 = float((n + 1) ** 2)
    sweep, fill = ctypes.c_double(), ctypes.c_double()
    ndof = L.pmg_ref_sor_bench(n, nsweeps, kappa2, hinv2, omega, ctypes.byref(sweep), ctypes.byref(fill))
    return int(ndof), float(sweep.value), float(fill.value)


def ref_sor_bench_csr(A_csr, nsweeps: int = 8, omega: float = 1.0):
    """(n, sec_per_sweep, sec_per_noise_fill): the same loop on a given
    matrix in colour-blocked row order (pass ``GraphOperator.to_csr()``:
    sweeping its rows in order is the reference's colour-by-colour
    multicolour SOR), the diagonal split off as the reference keeps it."""
    import scipy.sparse as sp

    L = sor_lib()
    A = sp.csr_matrix(A_csr)
    n = A.shape[0]
    diag = np.ascontiguousarray(A.diagonal(), dtype=np.float64)
    Aoff = (A - sp.diags(diag)).tocsr()
    Aoff.eliminate_zeros()
    rowptr, col = _csr(Aoff.indptr, Aoff.indices)
    val = np.ascontiguousarray(Aoff.data, dtype=np.float64)
    sweep, fill = ctypes.c_double(), ctypes.c_double()
    ndof = L.pmg_ref_sor_bench_csr(n, _ptr(rowptr, ctypes.c_int64), _ptr(col, ctypes.c_int32),
                                   _ptr(val, ctypes.c_double), _ptr(diag, ctypes.c_double), nsweeps, omega,
                                   ctypes.byref(sweep), ctypes.byref(fill))
    return int(ndof), float(sweep.value), float(fill.value)
