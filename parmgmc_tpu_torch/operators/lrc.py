"""Low-rank-corrected operators A_post = A + B Sigma^{-1} B^T (port of
``parmgmc_tpu.operators.lrc``).

The posterior precision of a Bayesian linear inverse problem with a
Gaussian prior N(0, A^{-1}), observation operator B^T and a diagonal
noise covariance Sigma.  ``B`` is stored grid-shaped ``(*grid, k)``;
``sigma_inv`` is the length-k diagonal of Sigma^{-1}.  The base is a
stencil operator or a :class:`~parmgmc_tpu_torch.operators.graph.
GraphOperator` (grid ``(n,)``, B ``(n, k)`` in its internal order); on a
graph base x may carry the chain axis, ``(n, C)``, and the products take
and give ``(k, C)`` coefficients.

Localized columns (ball averages) carry a sparse *patch view*: column j's
nonzeros lie in a box of a size common to all columns, starting at
``patch_starts[j]``.  The starts are Python ints fixed at create time, so
a window is a plain slice view of a grid tensor and a chain step never
reads an index from the device.  B^T x then reads k small windows and
y + B w writes them in place, instead of k full-grid passes each.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from parmgmc_tpu_torch.operators.stencil import StencilOperator

__all__ = [
    "LRCOperator",
    "column_patches",
    "fused_patch_apply_add_",
    "patch_apply_add",
    "patch_apply_add_",
    "patch_dot",
    "patch_index",
    "with_patches",
]


def window(start, box) -> tuple:
    """The slices of the box of extents ``box`` at ``start``."""
    return tuple(slice(s, s + e) for s, e in zip(start, box))


def nonzero_bounds(a: torch.Tensor):
    """[(lo, hi)] per axis of the nonzeros of ``a`` (the tight bounding
    box), or None when ``a`` is zero everywhere.  Set-up only: reads one
    small projection per axis to the host."""
    nz = a != 0
    out = []
    for ax in range(a.ndim):
        others = tuple(x for x in range(a.ndim) if x != ax)
        proj = (nz.any(dim=others) if others else nz).cpu()
        idx = torch.nonzero(proj).flatten()
        if idx.numel() == 0:
            return None
        out.append((int(idx[0]), int(idx[-1]) + 1))
    return out


def column_patches(cols_grid: torch.Tensor, max_fill: float = 0.25):
    """(patch_vals (k, *box), patch_starts) of a grid-shaped column stack
    ``(*grid, k)``, or None when a column is empty or the k boxes would
    cover more than ``max_fill`` of the grid.

    Every column's nonzero bounding box is padded to the largest extent
    on each axis and clamped into the grid; ``patch_starts`` is a tuple of
    k tuples of Python ints.  Works on any localized stack: B itself, and
    the Woodbury factor Bb, whose columns have exact compact support for
    red/black sweeps (one ring wider than B's).  Set-up only."""
    gshape = tuple(cols_grid.shape[:-1])
    k = cols_grid.shape[-1]
    bounds = [nonzero_bounds(cols_grid[..., j]) for j in range(k)]
    if any(b is None for b in bounds):
        return None
    ext = [max(b[ax][1] - b[ax][0] for b in bounds) for ax in range(len(gshape))]
    if math.prod(ext) * k > max_fill * math.prod(gshape):
        return None
    starts = tuple(
        tuple(min(b[ax][0], gshape[ax] - ext[ax]) for ax in range(len(gshape))) for b in bounds
    )
    vals = torch.stack([cols_grid[window(st, ext) + (j,)] for j, st in enumerate(starts)])
    return vals.contiguous(), starts


def patch_index(patch_starts, box, grid_shape, device) -> torch.Tensor:
    """(k, *box) flat grid indices of the k windows, for one gather of
    every window of a grid tensor (``torch.take``)."""
    flat = torch.arange(math.prod(grid_shape), device=device).reshape(grid_shape)
    return torch.stack([flat[window(st, box)] for st in patch_starts])


def patch_dot(patch_vals, patch_index, x):
    """(k,) = [<column_j, x>]: the k windows of x gathered at once
    (``patch_index``) and contracted with the columns' values."""
    dims = tuple(range(1, patch_vals.ndim))
    return (patch_vals * torch.take(x, patch_index)).sum(dim=dims)


def patch_apply_add_(patch_vals, patch_starts, w, y):
    """y += sum_j w[j] column_j, in place, one window at a time (windows
    may overlap); ``w`` is a (k,) tensor.  Returns y."""
    box = tuple(patch_vals.shape[1:])
    for j, st in enumerate(patch_starts):
        y[window(st, box)].addcmul_(patch_vals[j], w[j])
    return y


def patch_apply_add(patch_vals, patch_starts, w, y):
    """y + sum_j w[j] column_j as a new tensor."""
    return patch_apply_add_(patch_vals, patch_starts, w, y.clone())


def fused_patch_apply_add_(pv, starts, w, y):
    """y += sum_{i,j} w[i, j] column_{i,j}, in place, for m factor sets
    sharing per-column windows: ``pv`` (m, k, *box), ``w`` (m, k).  The
    sets are combined first, so each window is updated once."""
    m, k = pv.shape[:2]
    upd = (w.reshape(m, k, *([1] * (pv.ndim - 2))) * pv).sum(dim=0)
    box = tuple(pv.shape[2:])
    for j, st in enumerate(starts):
        y[window(st, box)].add_(upd[j])
    return y


@dataclass(frozen=True, eq=False)
class LRCOperator:
    """A + B diag(sigma_inv) B^T with a stencil or graph base operator A.

    ``patch_vals``/``patch_starts`` (optional, from :func:`with_patches`)
    are the sparse view of B; the dense B stays authoritative and the
    patch products equal the dense ones up to summation order."""

    base: StencilOperator  # or a GraphOperator
    B: torch.Tensor  # (*grid, k)
    sigma_inv: torch.Tensor  # (k,)
    patch_vals: "torch.Tensor | None" = None  # (k, *box)
    patch_starts: "tuple | None" = None  # k tuples of ndim ints

    def __post_init__(self):
        # the windows' flat indices, made once: B^T x is one gather
        index = None
        if self.patch_vals is not None:
            index = patch_index(self.patch_starts, tuple(self.patch_vals.shape[1:]),
                                self.grid_shape, self.patch_vals.device)
        object.__setattr__(self, "patch_index", index)

    @property
    def grid_shape(self):
        return self.base.grid_shape

    @property
    def ndim(self) -> int:
        return self.base.ndim

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def k(self) -> int:
        return self.B.shape[-1]

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def bt_apply(self, x):
        """(k,) = B^T x for a grid-shaped x; (k, C) for chain-major x."""
        if x.ndim > self.ndim:
            grid = list(range(self.ndim))
            return torch.tensordot(self.B, x, dims=(grid, grid))
        if self.patch_vals is not None:
            return patch_dot(self.patch_vals, self.patch_index, x)
        return torch.tensordot(x, self.B, dims=self.ndim)

    def b_apply(self, w):
        """Grid-shaped B w for a (k,) w (chain-major for a (k, C) w)."""
        if self.patch_vals is not None:
            y = torch.zeros(self.grid_shape, dtype=w.dtype, device=w.device)
            return patch_apply_add_(self.patch_vals, self.patch_starts, w, y)
        return self.B @ w

    def b_apply_add(self, w, y):
        """y + B w as a new tensor (windows only, with patches)."""
        if self.patch_vals is None:
            return y + self.B @ w
        return patch_apply_add(self.patch_vals, self.patch_starts, w, y)

    def b_apply_add_(self, w, y):
        """y += B w in place; returns y."""
        if self.patch_vals is None:
            return y.add_(self.B @ w)
        return patch_apply_add_(self.patch_vals, self.patch_starts, w, y)

    def apply(self, x):
        bt = self.bt_apply(x)
        ax = self.base.apply(x)
        if self.patch_vals is None:
            si = self.sigma_inv if bt.ndim == 1 else self.sigma_inv[:, None]
            return ax + self.B @ (si * bt)
        return patch_apply_add_(self.patch_vals, self.patch_starts, self.sigma_inv * bt, ax)

    def to_dense(self) -> torch.Tensor:
        Bf = self.B.reshape(self.n, self.k)
        return self.base.to_dense() + (Bf * self.sigma_inv) @ Bf.T


def with_patches(op: LRCOperator, max_fill: float = 0.25) -> LRCOperator:
    """``op`` with the patch view of B attached when its columns are
    localized (:func:`column_patches`); unchanged when they are not or a
    column is empty.  Set-up only."""
    if op.patch_vals is not None:
        return op
    p = column_patches(op.B, max_fill)
    if p is None:
        return op
    return LRCOperator(base=op.base, B=op.B, sigma_inv=op.sigma_inv,
                       patch_vals=p[0], patch_starts=p[1])
