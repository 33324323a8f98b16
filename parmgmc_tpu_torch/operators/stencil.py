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

The geometric grid transfers live here too: vertex-style coarsening to
``ceil(n/2)`` points an axis, :func:`prolong` by (bi/tri)linear
interpolation, :func:`restrict` its exact transpose, and
:func:`galerkin_coarse_operator`, the exact P^T A P of any stencil as a
coarse stencil, read off comb probes.
"""

from __future__ import annotations

import itertools
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
    "prolong",
    "restrict",
    "galerkin_coarse_operator",
    "lattice",
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


def lattice(t: torch.Tensor, starts, counts, step: int = 1) -> torch.Tensor:
    """The strided view t[..., starts + step k] (k < counts) of t's trailing
    grid dims: one ``as_strided`` call, where indexing would cost one
    slice an axis on the host."""
    lead = t.dim() - len(starts)
    st = t.stride()
    return t.as_strided(
        (*t.shape[:lead], *counts),
        (*st[:lead], *(s * step for s in st[lead:])),
        t.storage_offset() + sum(a * s for a, s in zip(starts, st[lead:])),
    )


def _shifted(xp: torch.Tensor, off, shape, pad: int) -> torch.Tensor:
    """View of the padded ``xp`` holding x[i + off] at index i (grid dims
    trailing)."""
    return lattice(xp, [pad + o for o in off], shape)


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

    def to_csr(self):
        """scipy CSR in float64 on the host (the sparse exact sampler's
        input): row i holds diag[i] and coeff_o[i] at column i + o for
        every in-grid offset o, as :meth:`apply`."""
        import numpy as np
        import scipy.sparse as sp

        shape = self.grid_shape
        n = self.n
        idx = np.arange(n).reshape(shape)
        rows, cols = [np.arange(n)], [np.arange(n)]
        vals = [self.diag.detach().cpu().double().numpy().reshape(-1)]
        for off, c in zip(self.offsets, self.coeffs):
            src = tuple(slice(max(0, -o), s - max(0, o)) for o, s in zip(off, shape))
            dst = tuple(slice(max(0, o), s - max(0, -o)) for o, s in zip(off, shape))
            r = idx[src].reshape(-1)
            rows.append(r)
            cols.append(idx[dst].reshape(-1))
            ca = c.detach().cpu().double().numpy()
            vals.append(np.full(r.size, float(ca)) if ca.ndim == 0 else ca[src].reshape(-1))
        return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                             shape=(n, n))


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
        # made on the device (no copy from the host, which a captured step
        # could not hold)
        c = torch.full((), -self.hinv2, dtype=self._dtype, device=self._device)
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


# Grid transfers (geometric multigrid).  Coarse node i sits at fine node
# 2i; odd fine nodes interpolate linearly from their coarse neighbours.  On
# an even extent the last fine node has one coarse neighbour and takes its
# full weight, so constants are interpolated exactly everywhere.  R = P^T
# exactly, which makes the Galerkin product P^T A P exact.  The arithmetic
# is the JAX package's, term for term; the layout is built from slices,
# stacks and reshapes.


def _prolong_1d(c: torch.Tensor, axis: int, nf: int) -> torch.Tensor:
    """Linear interpolation along ``axis`` from ceil(nf/2) to nf points."""
    c = torch.movedim(c, axis, -1)
    head = c.shape[:-1]
    if nf % 2:
        mid = 0.5 * (c[..., :-1] + c[..., 1:])
        pairs = torch.stack([c[..., :-1], mid], dim=-1).reshape(*head, nf - 1)
        z = torch.cat([pairs, c[..., -1:]], dim=-1)
    else:
        # the last odd fine node takes full weight from c[-1]:
        # 0.5 (c[-1] + 0) + 0.5 c[-1], as the JAX boundary fix adds it
        last = 0.5 * c[..., -1:] + 0.5 * c[..., -1:]
        od = torch.cat([0.5 * (c[..., :-1] + c[..., 1:]), last], dim=-1)
        z = torch.stack([c, od], dim=-1).reshape(*head, nf)
    return torch.movedim(z, -1, axis)


def _restrict_1d(f: torch.Tensor, axis: int) -> torch.Tensor:
    """The exact transpose of :func:`_prolong_1d` along ``axis``."""
    f = torch.movedim(f, axis, -1)
    nf = f.shape[-1]
    zero = f.new_zeros((*f.shape[:-1], 1))
    if nf % 2:
        half = 0.5 * f[..., 1::2]  # the nc - 1 interior odd nodes
        y = f[..., 0::2] + torch.cat([half, zero], dim=-1)
        y = y + torch.cat([zero, half], dim=-1)
    else:
        ev, od = f[..., 0::2], f[..., 1::2]
        y = ev + 0.5 * od + 0.5 * torch.cat([zero, od[..., :-1]], dim=-1)
        # transpose of the boundary fix: f[-1] contributes 1.0 in total
        y = torch.cat([y[..., :-1], y[..., -1:] + 0.5 * od[..., -1:]], dim=-1)
    return torch.movedim(y, -1, axis)


def prolong(xc: torch.Tensor, fine_shape: Sequence[int]) -> torch.Tensor:
    """Interpolate a coarse field to the fine grid ((bi/tri)linear); the
    grid is the leading ``len(fine_shape)`` dims."""
    y = xc
    for axis, nf in enumerate(fine_shape):
        y = _prolong_1d(y, axis, int(nf))
    return y


def restrict(xf: torch.Tensor, ndim: "int | None" = None) -> torch.Tensor:
    """Full-weighting restriction, the exact transpose of :func:`prolong`,
    over the leading ``ndim`` dims (all of them when None)."""
    y = xf
    for axis in range(xf.ndim if ndim is None else ndim):
        y = _restrict_1d(y, axis)
    return y


def galerkin_coarse_operator(op: StencilOperator, transfer=None) -> StencilOperator:
    """The exact Galerkin product A_c = P^T A P as a coarse stencil, with P
    the linear :func:`prolong` or ``transfer``'s.

    T = R A P has radius rc = (r + 2)//2 on the coarse grid, so its
    coefficient fields come out of T applied to ``spacing^d`` comb grids,
    spacing = 2 rc + 2: impulses that far apart never interact, and row j's
    coefficient at offset ``off`` is the response, at j, of the comb of
    phase (j + off) mod spacing.  Each comb's response is copied into the
    fields as it is made (the nodes j whose phase code (j + off) mod
    spacing is p form one strided sublattice), so no stack of responses
    is held: peak memory is the output fields and the fine-grid
    temporaries of one probe.  Values are those of the JAX gather, entry
    for entry."""
    fshape = op.grid_shape
    cshape = coarse_shape(fshape)
    d = len(fshape)
    rc = (op.radius + 2) // 2
    spacing = 2 * rc + 2
    if transfer is None:
        up, down = (lambda v: prolong(v, fshape)), (lambda v: restrict(v, d))
    else:
        up, down = transfer.prolong, transfer.restrict
    rng = range(-rc, rc + 1)
    zero = (0,) * d
    offsets = tuple(off for off in itertools.product(rng, repeat=d) if any(o != 0 for o in off))
    fields = {off: torch.zeros(cshape, dtype=op.dtype, device=op.device) for off in (*offsets, zero)}
    # phase code of each coarse node, one axis at a time: i mod spacing
    codes = []
    for ax, n in enumerate(cshape):
        view = [1] * d
        view[ax] = n
        codes.append((torch.arange(n, device=op.device) % spacing).reshape(view))
    for phase in itertools.product(range(spacing), repeat=d):
        comb = torch.ones((1,) * d, dtype=op.dtype, device=op.device)
        for code, p in zip(codes, phase):
            comb = comb * (code == p).to(op.dtype)
        u = down(op.apply(up(comb)))
        for off, field in fields.items():
            sub = tuple(slice((p - o) % spacing, None, spacing) for p, o in zip(phase, off))
            field[sub] = u[sub]
    return StencilOperator(
        offsets=offsets, coeffs=tuple(fields[off] for off in offsets), diag=fields[zero]
    )
