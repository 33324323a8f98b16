"""Build and load seam of the hand-written CUDA kernels.

The sources in ``parmgmc_tpu_torch/csrc/*.cu`` expose a plain C
interface.  :func:`lib` compiles them at first use with ``nvcc`` for
Hopper (``sm_90a``) into one shared library under ``build/`` at the root
of the checkout, loads it with ``ctypes`` and declares every entry
point's argument types (the pattern of ``parmgmc_tpu/native``).  The
build is redone when a source is newer than the library.  Nothing here
runs at import: the CPU tests import every module on a machine without
``nvcc``.

Each kernel wrapper counts its launches (:func:`launch_counts`), so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

__all__ = [
    "build",
    "lib",
    "check_launch",
    "check_input",
    "count_launches",
    "given",
    "launch_counts",
    "occupancy",
    "prefix_pointer",
    "reset_launch_counts",
    "scalar_array",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "parmgmc_tpu_torch")
_SO = os.path.join(BUILD_DIR, "libparmgmc_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# strips of the marching kernels, (axis-0 halo, T1, T2) in csrc/*.cu; the
# twins' partial sums follow the launch plans built on them
# (kernels/_march.py), so the loader checks them
TILES = {"chain_march": (3, 32, 32), "sweep_march": (2, 32, 32)}

MAX_OFF = 26  # offsets of a radius-1 3D stencil

_LOCK = threading.Lock()
_LIB = None
# one count per wrapper: fused_chain_down_fd, fused_tail_down (one
# cooperative launch a call, every tail level), fused_rb_gibbs_sweep_fd, fused_rb_gibbs_sweep, fused_patch_sweep_sqfd (one
# cooperative launch), fused_patch_sweep_sqfd_streamed (one C call that
# enqueues a launch per phase), the colourwise patch check (one C call, a
# launch per colour; on no sampler path), fused_chain_down_2d_staged,
# fused_chain_down_2d, fused_zero_gibbs_restrict_fd,
# fused_rb_gibbs_sweep_2d_staged and fused_rb_gibbs_sweep_2d (either diagonal);
# galerkin_sweep, the launches of fused_galerkin_sweep (kernels.galerkin_sweep);
# residual_restrict, the launches of kernels.residual_restrict (one a call);
# prolong_add, the launches of kernels.prolong_add (one a call);
# and chain_step_graph, the replays of a captured chain step
# (parmgmc_tpu_torch.replay), each of which also counts the kernels it holds
_LAUNCHES = {
    "chain_down": 0, "tail_down": 0, "rb_gibbs_fd": 0, "rb_gibbs": 0,
    "patch_sweep": 0, "patch_sweep_streamed": 0, "patch_sweep_colourwise": 0,
    "chain_2d_staged": 0, "chain_2d": 0, "zero_restrict": 0,
    "rb_gibbs_2d_staged": 0, "rb_gibbs_2d": 0, "galerkin_sweep": 0, "residual_restrict": 0,
    "prolong_add": 0, "chain_step_graph": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
# the marching sweeps: (x, b, d, out, n0, n1, n2, t0, use_tma, six
# coefficients, kappa2, hinv2, omega, nscale, prefix, prefix_at (the prefix
# in device memory, or NULL), color0, with_noise, row_offset, n0_global,
# stream)
_MARCH_SWEEP = ([_P] * 4 + [_I] * 5 + [_F] * 10 + [_U, _P, _I, _I, _I, _I, _P], _I)
# the patch sweeps: (x, b, out, n0, n1, n2, kappa2, hinv2, prefixes,
# with_noise, stream)
_PATCH = ([_P] * 3 + [_I] * 3 + [_F] * 2 + [ctypes.POINTER(_U), _I, _P], _I)
# the marching chain: (x, b, z, xpy, rc, xsum, zsum, n0, n1, n2, t0,
# use_tma, six coefficients, kappa2, hinv2, omega, nscale, prefix,
# prefix_at, color0, with_noise, row_offset, n0_global, stream)
_MARCH_CHAIN = ([_P] * 7 + [_I] * 5 + [_F] * 10 + [_U, _P, _I, _I, _I, _I, _P], _I)
_SIGNATURES = {
    "pmg_chain_march": _MARCH_CHAIN,
    "pmg_chain_march_fd": _MARCH_CHAIN,
    # (b, out, shapes, params, prefixes, prefix_at, offsets, nlev, need,
    # color0, with_noise, stream)
    "pmg_tail_grid": ([_P] * 7 + [_I] * 4 + [_P], _I),
    "pmg_sweep_march_staged": _MARCH_SWEEP,
    "pmg_sweep_march_windowed": _MARCH_SWEEP,
    "pmg_sweep_march_fd": _MARCH_SWEEP,
    "pmg_sweep_march_diag": _MARCH_SWEEP,
    # (x, out, b, fields, diag, n0, n1, n2, noff, offsets, slots, scalars_at,
    # omega, 1 - omega, nfac, prefix, prefix_at, backward, with_noise, stream)
    "pmg_galerkin_sweep": ([_P] * 5 + [_I] * 4 + [_P] * 3 + [_F] * 3 + [_U, _P, _I, _I, _P], _I),
    # (x, b, out, fields, scal, scal_at, offs, noff, diag, kappa2, hinv2, n0,
    # n1, n2, restrict, stream)
    "pmg_residual_restrict": ([_P] * 7 + [_I, _P, _F, _F] + [_I] * 4 + [_P], _I),
    # (y, z, out, n0, n1, n2, stream)
    "pmg_prolong_add": ([_P] * 3 + [_I] * 3 + [_P], _I),
    "pmg_patch_sweep": _PATCH,
    "pmg_patch_sweep_streamed": _PATCH,
    "pmg_patch_sweep_colourwise": _PATCH,
    "pmg_chain_march_tile": ([ctypes.POINTER(_I)], None),
    "pmg_sweep_march_tile": ([ctypes.POINTER(_I)], None),
    "pmg_chain_march_occupancy": ([_I, _I, _I, ctypes.POINTER(_I)], None),
    "pmg_sweep_march_occupancy": ([_I, _I, ctypes.POINTER(_I)], None),
    "pmg_tail_grid_occupancy": ([ctypes.POINTER(_I)], None),
}


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def build(verbose: bool = False) -> float:
    """Compile ``csrc/*.cu`` into the shared library if it is missing or
    older than a source; returns the seconds spent (0.0 when current).
    Each source gets its own ``nvcc``, all started together, and one more
    links the objects.  ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report of registers, shared memory and spills."""
    deps = _sources() + glob.glob(os.path.join(_CSRC, "*.cuh"))
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= max(
        os.path.getmtime(p) for p in deps
    ):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in _sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *extra, *NVCC_FLAGS, "-I", _CSRC, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for obj, src in zip(objs, _sources())
        ]
        report = "".join(p.communicate()[0] for p in procs)
        so = os.path.join(tmp, os.path.basename(_SO))
        ok = all(p.returncode == 0 for p in procs)
        if ok:
            res = subprocess.run([nvcc, "-shared", "-o", so, *objs],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            report += res.stdout
            ok = res.returncode == 0
        if not ok:
            raise RuntimeError(f"nvcc failed:\n{report}")
        os.replace(so, _SO)
    if verbose:
        print(report)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            so = ctypes.CDLL(_SO)
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = restype
            for name, tile in TILES.items():
                out = (_I * 3)()
                getattr(so, f"pmg_{name}_tile")(out)
                if tuple(out) != tile:
                    raise RuntimeError(f"csrc {name} kernel tile {tuple(out)} != {tile}")
            _LIB = so
        return _LIB


def occupancy(entry: str, *flags) -> dict:
    """What the card gives a marching kernel's launch: blocks an SM, SMs
    and dynamic shared bytes, from ``pmg_<entry>_occupancy(*flags)`` (the
    streams the launch reads; see csrc/chain_march.cu, sweep_march.cu)."""
    out = (_I * 3)()
    getattr(lib(), f"pmg_{entry}_occupancy")(*flags, out)
    return dict(blocks_per_sm=out[0], sms=out[1], smem_bytes=out[2])


def check_input(name: str, t, like) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor on ``like``'s
    device: what every kernel takes."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, x on {like.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def given(**kw) -> dict:
    """The keyword arguments of ``kw`` that are not None: a replayed
    step's ``prefix_at`` and ``out``, left out of an eager call, so that a
    plain twin can stand in for the kernel there."""
    return {k: v for k, v in kw.items() if v is not None}


def prefix_pointer(prefix_at, n: int, like):
    """The device address of a launch's hash prefixes in memory: None for
    ``prefix_at`` None (the kernel takes the prefix by value), else the
    address of ``prefix_at``, a contiguous int32 tensor of ``n`` words (the
    uint32 prefixes' bits) on ``like``'s device."""
    if prefix_at is None:
        return None
    if prefix_at.device != like.device or prefix_at.dtype != torch.int32:
        raise ValueError(f"prefix_at must be int32 on {like.device}, got {prefix_at.dtype} "
                         f"on {prefix_at.device}")
    if prefix_at.numel() != n or not prefix_at.is_contiguous():
        raise ValueError(f"prefix_at must hold {n} contiguous words, got {tuple(prefix_at.shape)}")
    return prefix_at.data_ptr()


def scalar_array(scalars, device) -> torch.Tensor:
    """A radius-1 3D stencil's scalar coefficients (float32 values, 0.0
    where a field) as :data:`MAX_OFF` float32 values on ``device``, 0.0
    past the offsets: what a 27-point kernel reads at one fixed index an
    offset."""
    return torch.tensor(list(scalars) + [0.0] * (MAX_OFF - len(scalars)), dtype=torch.float32,
                        device=device)


def check_launch(err: int, name: str, n: int = 1) -> None:
    """Count ``n`` launches of kernel ``name`` (one C call's); raise if
    they were refused."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")
    _LAUNCHES[name] += n


def count_launches(counts: dict) -> None:
    """Add ``counts`` (kernel name -> launches, negative to take back) to
    the counters: a replayed graph counts the launches it holds."""
    for name, n in counts.items():
        _LAUNCHES[name] += n


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
