"""Whole-array helpers shared by the kernels' plain-torch twins."""

from __future__ import annotations

import math

import numpy as np
import torch

from parmgmc_tpu_torch.operators.stencil import link_count

__all__ = [
    "shift", "star_neigh", "parity", "restrict2", "tile_sums", "scalar", "fd_diag",
    "flat_index", "noise_factor", "f32", "Rows", "on_inside",
]


class Rows:
    """Where a block of grid rows lies in the global grid: array row i is
    global row ``g = offset + i`` of ``n0`` global rows.  A whole grid has
    offset 0 and n0 its own extent; a halo-extended shard (the sharded
    sampler, ``parmgmc_tpu_torch.parallel.fused``) has a negative offset on
    the first shard and rows past the end on the last.  The kernels and
    twins key the red/black parity, the link count of the FD diagonal and
    the noise counter by g; array rows outside the global grid are outside
    the grid: they read as zeros and come out as zeros, so no row reads a
    neighbour across a global end (:meth:`inside`, :func:`on_inside`)."""

    def __init__(self, n0_array: int, row_offset: int = 0, n0_global=None):
        self.offset = int(row_offset)
        self.n0 = int(n0_array if n0_global is None else n0_global)
        self.n0_array = int(n0_array)

    @property
    def whole(self) -> bool:
        """Is the block the whole grid?"""
        return self.offset == 0 and self.n0 == self.n0_array

    def inside(self) -> tuple:
        """(lo, hi): the array rows inside the global grid."""
        return max(0, -self.offset), min(self.n0_array, self.n0 - self.offset)

    def check(self, plane: int) -> None:
        """Raise unless the global grid keeps the 32-bit noise counter."""
        if self.n0 * plane >= 2**32:
            raise ValueError("the noise counter is 32-bit: grids need fewer than 2^32 points")


def shift(v: torch.Tensor, axis: int, by: int) -> torch.Tensor:
    """v[..., i + by, ...] along ``axis`` with zero fill (|by| = 1)."""
    n = v.shape[axis]
    zshape = list(v.shape)
    zshape[axis] = abs(by)
    zeros = v.new_zeros(zshape)
    if by > 0:
        return torch.cat([v.narrow(axis, by, n - by), zeros], dim=axis)
    return torch.cat([zeros, v.narrow(axis, 0, n + by)], dim=axis)


def on_inside(fn, rows: Rows, arrays, outs_per_row):
    """``fn(rows', *arrays')`` on the array rows inside the global grid
    (``arrays`` sliced to them, None kept; ``rows'`` their place), each
    output padded back with zero rows: ``outs_per_row`` gives, an output,
    its rows a grid row (1, or 1/2 for a restriction).  For a whole grid,
    ``fn(rows, *arrays)``."""
    if rows.whole:
        return fn(rows, *arrays)
    lo, hi = rows.inside()
    inner = Rows(hi - lo, rows.offset + lo, rows.n0)
    outs = fn(inner, *(None if a is None else a[lo:hi] for a in arrays))
    single = not isinstance(outs, tuple)
    padded = []
    for o, per in zip((outs,) if single else outs, outs_per_row):
        full = o.new_zeros((int(rows.n0_array * per), *o.shape[1:]))
        full[int(lo * per) : int(hi * per)] = o
        padded.append(full)
    return padded[0] if single else tuple(padded)


def star_neigh(v: torch.Tensor, c) -> torch.Tensor:
    """Off-diagonal star sum with the scalar tensors ``c`` ordered
    (-e0, +e0, -e1, +e1, -e2, +e2), summed left to right as the kernels
    do; zero outside the grid."""
    return (
        c[0] * shift(v, 0, -1) + c[1] * shift(v, 0, 1)
        + c[2] * shift(v, 1, -1) + c[3] * shift(v, 1, 1)
        + c[4] * shift(v, 2, -1) + c[5] * shift(v, 2, 1)
    )


def parity(shape, device, row_offset: int = 0) -> torch.Tensor:
    """(g + j + k) % 2 over a 3D grid, g = row_offset + i the global row."""
    n0, n1, n2 = shape
    i = (row_offset + torch.arange(n0, device=device)).reshape(n0, 1, 1)
    j = torch.arange(n1, device=device).reshape(1, n1, 1)
    k = torch.arange(n2, device=device).reshape(1, 1, n2)
    return (i + j + k) % 2


def flat_index(shape, device, row_offset: int = 0) -> torch.Tensor:
    """Row-major flat index of every grid point in the global grid whose
    row ``row_offset`` is array row 0 (int64): the noise counter.  Rows
    above the global grid get negative indices, whose low 32 bits are the
    kernels' wrapped uint32 counter."""
    start = row_offset * math.prod(shape[1:])
    return torch.arange(start, start + math.prod(shape), device=device,
                        dtype=torch.int64).reshape(shape)


def restrict2(r: torch.Tensor) -> torch.Tensor:
    """2x2x2 aggregate sums: axis-0 pairs, then axis 1, then axis 2."""
    n0, n1, n2 = r.shape
    v = r.reshape(n0 // 2, 2, n1, n2)
    v = (v[:, 0] + v[:, 1]).reshape(n0 // 2, n1 // 2, 2, n2)
    v = (v[:, :, 0] + v[:, :, 1]).reshape(n0 // 2, n1 // 2, n2 // 2, 2)
    return v[..., 0] + v[..., 1]


def tile_sums(v: torch.Tensor, tile) -> torch.Tensor:
    """Sums of v over the blocks of a ``tile`` grid (ragged edge padded
    with zeros), flattened in the kernels' block order."""
    pads = []
    for s, t in zip(reversed(v.shape), reversed(tile)):
        pads += [0, (-s) % t]
    vp = torch.nn.functional.pad(v, pads)
    g = [s // t for s, t in zip(vp.shape, tile)]
    return vp.reshape(g[0], tile[0], g[1], tile[1], g[2], tile[2]).sum(dim=(1, 3, 5)).reshape(-1)


def scalar(v: float, dtype, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=dtype, device=device)


def fd_diag(shape, kappa2, hinv2, dtype, device, rows: "Rows | None" = None) -> torch.Tensor:
    """kappa2 + hinv2 * links with the scalars at the working precision;
    for a block of a larger grid (``rows``) the axis-0 links count the
    global rows."""
    if rows is None or rows.whole:
        links = link_count(shape, dtype, device)
    else:  # the in-plane links, then axis 0's of the global rows
        g = rows.offset + torch.arange(shape[0], device=device).reshape(-1, 1, 1)
        links = link_count((1, *shape[1:]), dtype, device) + (
            (g >= 1).to(dtype) + (g <= rows.n0 - 2).to(dtype))
    return scalar(kappa2, dtype, device) + scalar(hinv2, dtype, device) * links


def noise_factor(omega: float, dtype=torch.float32) -> float:
    """sqrt((2 - omega)/omega) evaluated at ``dtype`` on the host (numpy
    scalars round each operation like the device does)."""
    t = np.float32 if dtype == torch.float32 else np.float64
    om = t(omega)
    return float(np.sqrt((t(2.0) - om) / om))


def f32(v: float) -> float:
    """``v`` rounded to float32 (the value a kernel's float argument holds)."""
    return float(np.float32(v))
