"""Structured-grid stencil operators (port of ``parmgmc_tpu.operators.stencil``).

An SPD operator A on an ``(n0, n1[, n2])`` grid is a stencil field:

* ``offsets`` -- tuple of nonzero integer off-diagonal offsets (``{-1,0,1}^d``
  for 5/7-point stencils; squared operators reach radius 2),
* ``coeffs`` -- one coefficient per offset, a 0-d tensor (constant
  coefficient) or a grid-shaped tensor,
* ``diag`` -- the grid-shaped diagonal.

``apply`` is a sum of shifted element-wise products; out-of-grid
neighbours contribute zero through zero padding (``radius`` wide),
which reproduces the "links that exist" boundary convention of the
reference FD assembly.
Operators accept leading batch dimensions on ``x`` (the grid is always
the trailing ``ndim`` dimensions), which :meth:`StencilOperator.to_dense`
uses to apply A to every unit vector at once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from parmgmc_tpu_torch import resolve_device

__all__ = [
    "StencilOperator",
    "FDStencilOperator",
    "fd_stencil",
    "shifted_laplace_fd",
    "detect_fd_params",
    "coarse_shape",
    "star_offsets",
    "link_count",
    "compress_stencil",
]


def star_offsets(d: int) -> tuple:
    """The 2d unit offsets ordered (-e0, +e0, -e1, +e1, ...)."""
    offs = []
    for axis in range(d):
        for s in (-1, 1):
            off = [0] * d
            off[axis] = s
            offs.append(tuple(off))
    return tuple(offs)


def link_count(grid_shape, dtype, device) -> torch.Tensor:
    """Number of in-grid neighbours of every grid point."""
    grid_shape = tuple(grid_shape)
    links = torch.zeros(grid_shape, dtype=dtype, device=device)
    for ax, n in enumerate(grid_shape):
        i = torch.arange(n, device=device)
        m = ((i >= 1).to(dtype) + (i <= n - 2).to(dtype))
        view = [1] * len(grid_shape)
        view[ax] = n
        links = links + m.reshape(view)
    return links


def _shifted(xp: torch.Tensor, off, shape, pad: int) -> torch.Tensor:
    """View of the padded ``xp`` holding x[i + off] at index i (grid dims
    trailing)."""
    sl = tuple(slice(pad + o, pad + o + s) for o, s in zip(off, shape))
    return xp[(Ellipsis, *sl)]


@dataclass(frozen=True, eq=False)
class StencilOperator:
    """SPD operator A on a structured grid, stored as a stencil field."""

    offsets: tuple
    coeffs: tuple
    diag: torch.Tensor

    @property
    def grid_shape(self) -> tuple:
        return tuple(self.diag.shape)

    @property
    def ndim(self) -> int:
        return len(self.grid_shape)

    @property
    def n(self) -> int:
        return math.prod(self.grid_shape)

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    def is_star(self) -> bool:
        """True if every offset touches exactly one coordinate (5/7-point)."""
        return all(sum(o != 0 for o in off) == 1 for off in self.offsets)

    @property
    def radius(self) -> int:
        return max((max(abs(o) for o in off) for off in self.offsets), default=1)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x (grid in the trailing dims of x)."""
        return self.diag * x + self.offdiag_apply(x)

    def offdiag_apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = (A - D) x -- the neighbour contributions only."""
        shape = self.grid_shape
        r = self.radius
        xp = F.pad(x, [r, r] * self.ndim)
        y = torch.zeros_like(x)
        for off, c in zip(self.offsets, self.coeffs):
            y = y + c * _shifted(xp, off, shape, r)
        return y

    def to_dense(self) -> torch.Tensor:
        """The dense (n, n) matrix.  For tests and coarse grids only."""
        n = self.n
        eye = torch.eye(n, dtype=self.dtype, device=self.device)
        cols = self.apply(eye.reshape(n, *self.grid_shape)).reshape(n, n)
        return cols.T.contiguous()  # cols[i] = A e_i is column i


class FDStencilOperator(StencilOperator):
    """Link-count FD operator whose ``diag`` and ``coeffs`` are made on
    access from the two scalars (kappa2, hinv2): off-diagonals
    ``-hinv2``, diagonal ``kappa2 + hinv2 * #in-grid neighbours``.  Holds
    no grid-sized state, so a large hierarchy costs nothing to build."""

    def __init__(self, kappa2, hinv2, grid_shape, dtype=torch.float32, device=None):
        # scalars rounded to the operator dtype, as the JAX operator stores them
        k2 = float(torch.tensor(float(kappa2), dtype=dtype))
        h2 = float(torch.tensor(float(hinv2), dtype=dtype))
        object.__setattr__(self, "kappa2", k2)
        object.__setattr__(self, "hinv2", h2)
        object.__setattr__(self, "_grid_shape", tuple(int(s) for s in grid_shape))
        object.__setattr__(self, "_dtype", dtype)
        object.__setattr__(self, "_device", resolve_device(device))
        object.__setattr__(self, "offsets", star_offsets(len(self._grid_shape)))

    @property
    def grid_shape(self) -> tuple:
        return self._grid_shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    def links(self) -> torch.Tensor:
        return link_count(self._grid_shape, self._dtype, self._device)

    @property
    def diag(self) -> torch.Tensor:
        return self.kappa2 + self.hinv2 * self.links()

    @property
    def coeffs(self) -> tuple:
        c = torch.tensor(-self.hinv2, dtype=self._dtype, device=self._device)
        return tuple(c for _ in self.offsets)

    def fd_params(self) -> tuple:
        """(kappa2, hinv2) -- detect_fd_params' short-circuit."""
        return (self.kappa2, self.hinv2)


# above this many points fd_stencil returns the lazy operator
_FD_LAZY_THRESHOLD = 2**28


def fd_stencil(
    grid_shape: Sequence[int],
    kappa2: float,
    hinv2: float,
    dtype=torch.float32,
    device=None,
    lazy: "bool | str" = "auto",
) -> StencilOperator:
    """Link-count-form FD star operator (off-diagonals ``-hinv2``,
    diagonal ``kappa2 + hinv2 * #in-grid neighbours``).  Past
    ``_FD_LAZY_THRESHOLD`` points, or with ``lazy=True``, returns the
    :class:`FDStencilOperator` that holds only the two scalars."""
    grid_shape = tuple(int(s) for s in grid_shape)
    device = resolve_device(device)
    if lazy is True or (lazy == "auto" and math.prod(grid_shape) >= _FD_LAZY_THRESHOLD):
        return FDStencilOperator(kappa2, hinv2, grid_shape, dtype, device)
    k2 = torch.tensor(float(kappa2), dtype=dtype, device=device)
    h2 = torch.tensor(float(hinv2), dtype=dtype, device=device)
    diag = k2 + h2 * link_count(grid_shape, dtype, device)
    offsets = star_offsets(len(grid_shape))
    coeffs = tuple(-h2 for _ in offsets)
    return StencilOperator(offsets=offsets, coeffs=coeffs, diag=diag)


def shifted_laplace_fd(
    grid_shape: Sequence[int], kappa: float, dtype=torch.float32, device=None
) -> StencilOperator:
    """(kappa^2 - Laplace) with the reference FD convention: off-diagonals
    ``-1/h^2`` with ``h = 1/(n0 - 1)`` in every direction, diagonal
    ``kappa^2`` plus ``1/h^2`` per existing neighbour."""
    grid_shape = tuple(int(s) for s in grid_shape)
    hinv2 = float((grid_shape[0] - 1) ** 2)
    return fd_stencil(grid_shape, float(kappa) ** 2, hinv2, dtype, device)


def detect_fd_params(op: StencilOperator):
    """(kappa2, hinv2) as floats if ``op`` is in link-count FD form (all
    off-diagonals equal scalars ``-hinv2``, diag ``kappa2 + hinv2 *
    links``); else None."""
    if isinstance(op, FDStencilOperator):
        return op.fd_params()
    if any(c.ndim != 0 for c in op.coeffs):
        return None
    c0 = op.coeffs[0]
    if not all(bool(torch.allclose(c, c0)) for c in op.coeffs[1:]):
        return None
    hinv2 = -c0
    links = link_count(op.grid_shape, op.dtype, op.device).reshape(-1)
    mid = op.n // 2
    kappa2 = op.diag.reshape(-1)[mid] - hinv2 * links[mid]
    expected = kappa2 + hinv2 * links
    if bool(torch.allclose(op.diag.reshape(-1), expected, rtol=1e-6)):
        return (float(kappa2), float(hinv2))
    return None


def coarse_shape(fine_shape: Sequence[int]) -> tuple:
    return tuple((int(s) + 1) // 2 for s in fine_shape)


def compress_stencil(op: StencilOperator) -> StencilOperator:
    """Drop identically-zero offsets and turn coefficient fields that are
    constant where their neighbour exists into 0-d tensors (set-up time;
    reads each field to the host once)."""
    shape = op.grid_shape
    offsets, coeffs = [], []
    for off, c in zip(op.offsets, op.coeffs):
        if c.ndim == 0:
            if float(c) != 0.0:
                offsets.append(off)
                coeffs.append(c)
            continue
        # only entries whose neighbour is in the grid matter (the zero
        # padding nullifies the rest), so compare on that region only
        region = tuple(slice(max(0, -o), n - max(0, o)) for o, n in zip(off, shape))
        vals = c[region]
        if vals.numel() == 0:
            continue  # the neighbour never exists on this grid
        lo, hi = float(vals.min()), float(vals.max())
        if lo == 0.0 and hi == 0.0:
            continue
        offsets.append(off)
        coeffs.append(torch.tensor(lo, dtype=c.dtype, device=c.device) if lo == hi else c)
    return StencilOperator(offsets=tuple(offsets), coeffs=tuple(coeffs), diag=op.diag)
