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

B and every column stack derived from it (the Woodbury factor, the chain
kernel's responses) are a :class:`Columns`, the one place that decides a
product's form.  Localized columns (ball averages) carry a *window view*:
column j's nonzeros lie in a box of a size common to all columns, at
``starts[j]``, Python ints fixed at create time, so a window is a plain
slice of a grid tensor and a chain step never reads an index from the
device; B^T x reads k small windows and y + B w writes them in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from parmgmc_tpu_torch.operators.stencil import StencilOperator

__all__ = ["ColumnUnion", "Columns", "LRCOperator", "with_patches"]


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


def _box(bounds, shape, max_fill: float):
    """(ext, starts): the per-column boxes ``bounds`` ([(lo, hi)] per axis)
    padded to their largest extent and clamped into the grid ``shape``;
    None when a box is missing or the k boxes cover more than ``max_fill``
    of the grid."""
    if any(b is None for b in bounds):
        return None
    d = len(shape)
    ext = [max(b[a][1] - b[a][0] for b in bounds) for a in range(d)]
    if math.prod(ext) * len(bounds) > max_fill * math.prod(shape):
        return None
    return ext, tuple(tuple(min(b[a][0], shape[a] - ext[a]) for a in range(d)) for b in bounds)


def _placed(wins, ext, starts) -> torch.Tensor:
    """(k, *ext): the windows [(values, lows)] zero-padded into boxes of
    extent ``ext`` at ``starts``."""
    out = wins[0][0].new_zeros((len(wins), *ext))
    for j, ((w, los), st) in enumerate(zip(wins, starts)):
        out[(j, *window([lo - s for lo, s in zip(los, st)], w.shape))] = w
    return out


@dataclass(frozen=True, eq=False)
class Columns:
    """A stack of k grid-shaped columns: ``dense`` ``(*grid, k)``,
    authoritative where held (None for a stack kept as windows only: the
    chain kernel's responses), and, where the columns are localized, the
    window view ``vals`` ``(k, *box)`` at ``starts``.  A product takes the
    windows where there are some, and then equals the dense product up to
    summation order; chain-major x ``(*grid, C)`` and w ``(k, C)`` take
    the dense stack.  ``index`` holds the windows' indices into the flat
    grid where :meth:`dot` reads them (:meth:`indexed`)."""

    dense: "torch.Tensor | None"
    vals: "torch.Tensor | None" = None
    starts: "tuple | None" = None  # k tuples of ndim Python ints
    index: "torch.Tensor | None" = None  # (k, *box)

    def indexed(self) -> "Columns":
        """This stack with ``index``, made once, so that B^T x is one
        gather (B's stacks: :class:`LRCOperator`)."""
        if self.vals is None or self.index is not None:
            return self
        flat = torch.arange(math.prod(self.dense.shape[:-1]), device=self.vals.device)
        flat = flat.reshape(self.dense.shape[:-1])
        return replace(self, index=torch.stack([flat[window(st, self.box)] for st in self.starts]))

    @classmethod
    def of(cls, cols: torch.Tensor, max_fill: float = 0.25) -> "Columns":
        """The stack ``cols`` ``(*grid, k)``, with its window view when every
        column is nonzero somewhere and the k boxes lie within ``max_fill``
        of the grid: B, and the Woodbury factor Bb, whose columns have exact
        compact support for red/black sweeps.  Set-up only."""
        bounds = [nonzero_bounds(cols[..., j]) for j in range(cols.shape[-1])]
        box = _box(bounds, cols.shape[:-1], max_fill)
        if box is None:
            return cls(cols)
        ext, starts = box
        vals = torch.stack([cols[window(st, ext) + (j,)] for j, st in enumerate(starts)])
        return cls(cols, vals.contiguous(), starts)

    @classmethod
    def windows(cls, wins, shape, max_fill: float) -> "Columns | None":
        """A stack kept as windows only, from k windows [(values, lows)] on
        the grid ``shape``; None past ``max_fill`` of it.  Set-up only."""
        box = _box([[(lo, lo + n) for lo, n in zip(los, w.shape)] for w, los in wins], shape, max_fill)
        return None if box is None else cls(None, _placed(wins, *box), box[1])

    def derive(self, cols: torch.Tensor) -> "Columns":
        """The stack ``cols`` derived from this one (the Woodbury factor of
        B): windowed under :meth:`of`'s default fill exactly where this
        stack is."""
        return Columns(cols) if self.vals is None else Columns.of(cols)

    @property
    def windowed(self) -> bool:
        return self.vals is not None

    @property
    def box(self) -> tuple:
        return tuple(self.vals.shape[1:])

    def dot(self, x):
        """(k,) = B^T x for a grid-shaped x; (k, C) for chain-major x."""
        nd = self.dense.ndim - 1
        if x.ndim > nd:
            grid = list(range(nd))
            return torch.tensordot(self.dense, x, dims=(grid, grid))
        if self.vals is None:
            return torch.tensordot(x, self.dense, dims=nd)
        return (self.vals * torch.take(x, self.index)).sum(dim=tuple(range(1, self.vals.ndim)))

    def apply(self, w):
        """B w, grid-shaped for a (k,) w (chain-major for a (k, C) w)."""
        if self.vals is None:
            return self.dense @ w
        return self.add_(w, torch.zeros(self.dense.shape[:-1], dtype=w.dtype, device=w.device))

    def add_(self, w, y):
        """y += B w in place, one window at a time (windows may overlap);
        returns y."""
        if self.vals is None:
            return y.add_(self.dense @ w)
        box = self.box
        for j, st in enumerate(self.starts):
            y[window(st, box)].addcmul_(self.vals[j], w[j])
        return y

    def add(self, w, y):
        """y + B w as a new tensor."""
        if self.vals is None:
            return y + self.dense @ w
        return self.add_(w, y.clone())

    def sub_(self, w, y):
        """y -= B w in place; returns y."""
        if self.vals is None:
            return y.sub_(self.dense @ w)
        return self.add_(-w, y)


@dataclass(frozen=True, eq=False)
class ColumnUnion:
    """y += sum_i s_i B_i w_i for m stacks B_i of k columns on one grid.

    ``members`` holds the pairs (B_i, s_i), s_i = +1 or -1, in the order
    of the weights :meth:`add_` takes.  Where every member has a window
    view, ``vals`` ``(m, k, *ext)`` and ``starts`` hold them once more on
    per-column union windows, so that one update a window applies every
    member (zero padding is exact: every member has exact compact
    support).  Without them the members are applied one at a time, in
    ``order``."""

    members: tuple
    order: tuple
    vals: "torch.Tensor | None" = None
    starts: "tuple | None" = None

    @classmethod
    def of(cls, members, shape, views=None, order=None) -> "ColumnUnion":
        """The union of ``members`` [(stack, sign)] on the grid ``shape``,
        packed from ``views`` (the members' own stacks by default) and
        applied one at a time in ``order`` (theirs by default).  Set-up
        only."""
        views = [st for st, _ in members] if views is None else views
        order = tuple(range(len(members)) if order is None else order)
        if not all(v.windowed for v in views):
            return cls(tuple(members), order)
        d, k = len(shape), views[0].vals.shape[0]
        union = [[(min(v.starts[j][a] for v in views), max(v.starts[j][a] + v.box[a] for v in views))
                  for a in range(d)] for j in range(k)]
        ext, starts = _box(union, shape, math.inf)
        vals = torch.stack([_placed(list(zip(v.vals, v.starts)), ext, starts) for v in views])
        return cls(tuple(members), order, vals, starts)

    @property
    def packed(self) -> bool:
        return self.vals is not None

    def add_(self, ws, y):
        """y += sum_i s_i B_i ws[i] in place; returns y."""
        if self.vals is None:
            for i in self.order:
                stack, sign = self.members[i]
                (stack.add_ if sign > 0 else stack.sub_)(ws[i], y)
            return y
        w = torch.stack([wi if sign > 0 else -wi for wi, (_, sign) in zip(ws, self.members)])
        m, k = self.vals.shape[:2]
        upd = (w.reshape(m, k, *([1] * (self.vals.ndim - 2))) * self.vals).sum(dim=0)
        box = tuple(self.vals.shape[2:])
        for j, st in enumerate(self.starts):
            y[window(st, box)].add_(upd[j])
        return y


@dataclass(frozen=True, eq=False)
class LRCOperator:
    """A + B diag(sigma_inv) B^T with a stencil or graph base operator A.

    ``cols`` is B as a :class:`Columns` (with the window view of
    :func:`with_patches`; B alone when not given), and every product
    with B goes through it."""

    base: StencilOperator  # or a GraphOperator
    B: torch.Tensor  # (*grid, k)
    sigma_inv: torch.Tensor  # (k,)
    cols: "Columns | None" = None

    def __post_init__(self):
        object.__setattr__(self, "cols", (Columns(self.B) if self.cols is None else self.cols).indexed())

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
        return self.cols.dot(x)

    def b_apply(self, w):
        """Grid-shaped B w for a (k,) w (chain-major for a (k, C) w)."""
        return self.cols.apply(w)

    def b_apply_add(self, w, y):
        """y + B w as a new tensor."""
        return self.cols.add(w, y)

    def b_apply_add_(self, w, y):
        """y += B w in place; returns y."""
        return self.cols.add_(w, y)

    def apply(self, x):
        bt = self.bt_apply(x)
        si = self.sigma_inv if bt.ndim == 1 else self.sigma_inv[:, None]
        return self.cols.add_(si * bt, self.base.apply(x))

    def coarsened(self, base, transfer) -> "LRCOperator":
        """The LRC operator over the coarse ``base`` whose columns are
        restricted, B_c = P^T B, one column at a time."""
        Bc = torch.stack([transfer.restrict(self.B[..., j]) for j in range(self.k)], dim=-1)
        return LRCOperator(base=base, B=Bc, sigma_inv=self.sigma_inv)

    def to_dense(self) -> torch.Tensor:
        Bf = self.B.reshape(self.n, self.k)
        return self.base.to_dense() + (Bf * self.sigma_inv) @ Bf.T


def with_patches(op: LRCOperator, max_fill: float = 0.25) -> LRCOperator:
    """``op`` with the window view of B (:meth:`Columns.of`) when its
    columns are localized; without one when they are not or a column is
    empty.  Set-up only."""
    if op.cols.windowed:
        return op
    return LRCOperator(base=op.base, B=op.B, sigma_inv=op.sigma_inv, cols=Columns.of(op.B, max_fill))
