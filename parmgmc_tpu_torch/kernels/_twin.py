"""Whole-array helpers shared by the kernels' plain-torch twins."""

from __future__ import annotations

import math

import numpy as np
import torch

from parmgmc_tpu_torch.operators.stencil import link_count

__all__ = [
    "shift", "star_neigh", "parity", "restrict2", "tile_sums", "scalar", "fd_diag",
    "flat_index", "noise_factor", "f32",
]


def shift(v: torch.Tensor, axis: int, by: int) -> torch.Tensor:
    """v[..., i + by, ...] along ``axis`` with zero fill (|by| = 1)."""
    n = v.shape[axis]
    zshape = list(v.shape)
    zshape[axis] = abs(by)
    zeros = v.new_zeros(zshape)
    if by > 0:
        return torch.cat([v.narrow(axis, by, n - by), zeros], dim=axis)
    return torch.cat([zeros, v.narrow(axis, 0, n + by)], dim=axis)


def star_neigh(v: torch.Tensor, c) -> torch.Tensor:
    """Off-diagonal star sum with the scalar tensors ``c`` ordered
    (-e0, +e0, -e1, +e1, -e2, +e2), summed left to right as the kernels
    do; zero outside the grid."""
    return (
        c[0] * shift(v, 0, -1) + c[1] * shift(v, 0, 1)
        + c[2] * shift(v, 1, -1) + c[3] * shift(v, 1, 1)
        + c[4] * shift(v, 2, -1) + c[5] * shift(v, 2, 1)
    )


def parity(shape, device) -> torch.Tensor:
    """(i + j + k) % 2 over a 3D grid."""
    n0, n1, n2 = shape
    i = torch.arange(n0, device=device).reshape(n0, 1, 1)
    j = torch.arange(n1, device=device).reshape(1, n1, 1)
    k = torch.arange(n2, device=device).reshape(1, 1, n2)
    return (i + j + k) % 2


def flat_index(shape, device) -> torch.Tensor:
    """Row-major flat index of every grid point (int64): the noise counter."""
    return torch.arange(math.prod(shape), device=device, dtype=torch.int64).reshape(shape)


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


def fd_diag(shape, kappa2, hinv2, dtype, device) -> torch.Tensor:
    """kappa2 + hinv2 * links with the scalars at the working precision."""
    return scalar(kappa2, dtype, device) + scalar(hinv2, dtype, device) * link_count(
        shape, dtype, device
    )


def noise_factor(omega: float, dtype=torch.float32) -> float:
    """sqrt((2 - omega)/omega) evaluated at ``dtype`` on the host (numpy
    scalars round each operation like the device does)."""
    t = np.float32 if dtype == torch.float32 else np.float64
    om = t(omega)
    return float(np.sqrt((t(2.0) - om) / om))


def f32(v: float) -> float:
    """``v`` rounded to float32 (the value a kernel's float argument holds)."""
    return float(np.float32(v))
