"""MGMC coarse-tail down-phase: CUDA kernel wrapper and plain twin.

Port of ``parmgmc_tpu/kernels/mg_tail.py::fused_tail_down``.  For every
smoothed tail level (FD form, per-level ``(omega, kappa2, hinv2)``) it
draws per-DOF noise keyed exactly like the JAX ``_eta_hash`` (domain
``0xA511E9B3 + li``, ``li`` counted from the tail's first level), runs a
from-zero red/black sweep on the noisy RHS and restricts the residual of
the noise-free RHS by 2x2x2 aggregation to form the next level's RHS.
It returns each level's y and the coarsest RHS.

Unlike the TPU kernel, inputs and outputs are in the TRUE grid layout:
the duplicated (n0, S1, 128) layout existed for Mosaic's lane tiling.
On the GPU one call is ONE cooperative launch of ``csrc/tail_grid.cu``
for every level, as the TPU kernel is one launch: the whole grid works on
one level at a time, a grid barrier between levels (the source note says
why, and what bounds it).  The outputs are views of one buffer.  The
launch takes each level's hash prefix by value, or, with ``prefix_at`` (an
int32 CUDA tensor of one word a level), from device memory when it runs
(a step replayed from a CUDA graph, :mod:`parmgmc_tpu_torch.replay`).
:func:`tail_down_reference` is the twin, and matches the JAX
``tail_down_reference`` with the noise on, up to transcendental rounding.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.kernels import _noise, _twin

__all__ = ["MAX_LEVELS", "fused_tail_down", "tail_blocks", "tail_down_reference"]

MAX_LEVELS = 10  # smoothed levels one launch takes (csrc/tail_grid.cu)
_WARPS = 16  # warps a block of csrc/tail_grid.cu
_TILE = (8, 16, 32)  # cells a block takes at a time in its second phase


def _check_shapes(bl, shapes):
    shapes = tuple(tuple(int(s) for s in shp) for shp in shapes)
    if len(shapes) < 2:
        raise ValueError("the tail needs at least one smoothed level and the coarse level")
    if tuple(bl.shape) != shapes[0]:
        raise ValueError(f"entry RHS shape {tuple(bl.shape)} != {shapes[0]}")
    if bl.numel() >= 2**32:
        raise ValueError("the noise counter is 32-bit: grids need fewer than 2^32 points")
    for fine, coarse in zip(shapes[:-1], shapes[1:]):
        if len(fine) != 3 or any(s % 2 for s in fine) or coarse != tuple(s // 2 for s in fine):
            raise ValueError(f"tail levels must halve even 3D grids: {shapes}")
    return shapes


def _level_reference(b, omega, kappa2, hinv2, prefix, color0, with_noise):
    dt, dev = b.dtype, b.device
    shape = tuple(b.shape)
    D = _twin.fd_diag(shape, kappa2, hinv2, dt, dev)
    mh = -_twin.scalar(hinv2, dt, dev)

    def neigh(v):
        return mh * (
            _twin.shift(v, 0, -1) + _twin.shift(v, 0, 1)
            + _twin.shift(v, 1, -1) + _twin.shift(v, 1, 1)
            + _twin.shift(v, 2, -1) + _twin.shift(v, 2, 1)
        )

    bt = b
    if with_noise:
        eta = _noise.eta_hash(prefix, _twin.flat_index(shape, dev), dt)
        bt = b + (_twin.noise_factor(omega, dt) * torch.sqrt(D)) * eta
    par = _twin.parity(shape, dev)
    winv = _twin.scalar(omega, dt, dev) / D
    v0 = torch.where(par == color0, winv * bt, bt)
    y = torch.where(par != color0, winv * (v0 - neigh(v0)), v0)
    return y, _twin.restrict2(b - (D * y + neigh(y)))


def tail_down_reference(bl, level_params, seed, step, color0, shapes, with_noise=True):
    """Plain-torch twin of :func:`fused_tail_down` (any device)."""
    shapes = _check_shapes(bl, shapes)
    ys, cur = [], bl
    for li in range(len(shapes) - 1):
        om, k2, h2 = level_params[3 * li : 3 * li + 3]
        prefix = _noise.hash_prefix(seed, step, _noise.TAIL_DOMAIN + li)
        y, cur = _level_reference(cur, om, k2, h2, prefix, color0, with_noise)
        ys.append(y)
    return ys, cur


def tail_blocks(shapes) -> int:
    """Blocks the largest phase of the tail kernel has work for: the first
    level's noise phase, a warp 64 cells of a row and a block 16 warps, or
    a level's tile phase, a block a tile of :data:`_TILE` cells (levels:
    ``shapes`` but the coarse last).  The launch takes this many blocks,
    or as many as the card keeps resident if fewer."""
    n0, n1, n2 = shapes[0]
    tiles = max(math.prod(-(-n // t) for n, t in zip(shp, _TILE)) for shp in shapes[:-1])
    return max(-(-(n0 * n1 * -(-n2 // 64)) // _WARPS), tiles)


class _Layout:
    """Where every level's scratch (the kernel's phase-1 field), y and rc
    lie in the call's one buffer (each at a 128-B boundary), with the C
    arrays of one hierarchy's launch."""

    def __init__(self, shapes):
        L = len(shapes) - 1
        pos, off = 0, []
        for fine, coarse in zip(shapes[:-1], shapes[1:]):
            for shp in (fine, fine, coarse):  # v, y, rc
                off.append(pos)
                pos += -(-math.prod(shp) // 32) * 32
        self.total = pos
        self.views = [(off[3 * li + 1], shp) for li, shp in enumerate(shapes[:-1])]
        self.rhs = (off[-1], shapes[-1])
        self.nlev = L
        self.blocks = tail_blocks(shapes)
        self.shapes = (ctypes.c_int * (3 * (L + 1)))(*(n for shp in shapes for n in shp))
        self.off = (ctypes.c_longlong * (3 * L))(*off)


@functools.lru_cache(maxsize=64)
def _layout(shapes) -> _Layout:
    return _Layout(shapes)


def fused_tail_down(bl, level_params, seed, step, color0, shapes, with_noise=True,
                    prefix_at=None):
    """([y_0 .. y_{L-1}], coarse_rhs): the whole MGMC tail down-phase.

    ``shapes`` are the L smoothed true grid shapes and the coarse one;
    ``level_params`` is the flat (omega, kappa2, hinv2) per smoothed
    level.  CPU tensors run :func:`tail_down_reference`; CUDA tensors
    launch ``csrc/tail_grid.cu`` once for all levels (float32,
    contiguous, at most :data:`MAX_LEVELS` smoothed levels) or raise."""
    if bl.device.type == "cpu":
        return tail_down_reference(bl, level_params, seed, step, color0, shapes, with_noise)
    if bl.device.type != "cuda":
        raise ValueError(f"no tail kernel for device {bl.device}")
    shapes = _check_shapes(bl, shapes)
    if bl.dtype != torch.float32:
        raise TypeError(f"tail kernel takes a float32 RHS, got {bl.dtype}")
    if not bl.is_contiguous():
        raise ValueError("tail kernel takes a contiguous RHS")
    L = len(shapes) - 1
    if L > MAX_LEVELS:
        raise ValueError(f"the tail kernel takes at most {MAX_LEVELS} smoothed levels, got {L}")
    lay = _layout(shapes)
    at = kernels.prefix_pointer(prefix_at, L, bl)
    buf = torch.empty(lay.total, dtype=bl.dtype, device=bl.device)
    params = (ctypes.c_float * (4 * L))()
    prefixes = (ctypes.c_uint32 * L)()
    for li in range(L):
        om, k2, h2 = (float(v) for v in level_params[3 * li : 3 * li + 3])
        params[4 * li : 4 * li + 4] = [om, k2, h2, _twin.noise_factor(om)]
        prefixes[li] = _noise.hash_prefix(seed, step, _noise.TAIL_DOMAIN + li)
    with torch.cuda.device(bl.device):
        err = kernels.lib().pmg_tail_grid(
            bl.data_ptr(), buf.data_ptr(), lay.shapes, params, prefixes, at, lay.off, L,
            lay.blocks, int(color0), int(with_noise),
            torch.cuda.current_stream(bl.device).cuda_stream,
        )
    kernels.check_launch(err, "tail_down")
    ys = [buf[o : o + shp[0] * shp[1] * shp[2]].view(shp) for o, shp in lay.views]
    o, shp = lay.rhs
    return ys, buf[o : o + shp[0] * shp[1] * shp[2]].view(shp)
