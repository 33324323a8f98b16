"""Grid transfers (port of ``GeometricTransfer``, ``AggregateTransfer``
and ``SparseTransfer`` in ``parmgmc_tpu.operators.transfer``).

Both implement ``prolong(xc) -> xf``, ``restrict(xf) -> xc`` with
restrict = prolong^T and ``prolong_add(y, xc, out=None) = y + prolong(xc)``
(written into ``out`` when given), the grid in the leading
``len(fine_shape)`` dims.

:class:`GeometricTransfer` is the linear interpolation and full weighting
of :mod:`parmgmc_tpu_torch.operators.stencil` (``coarsening="linear"``,
the default hierarchy); on the card its ``prolong_add`` of a 3D float32
grid is one launch of :mod:`parmgmc_tpu_torch.kernels.prolong_add`.  In
:class:`AggregateTransfer` P injects each coarse value into its 2^d fine
block (an odd extent's last coarse cell covers one fine node); R = P^T
sums the block.  Sums
take the axis-0 pair first, then axis 1, then axis 2 -- the order the
CUDA kernels use for their fused restriction.

:class:`SparseTransfer` is the algebraic hierarchies' P (nf x nc), stored
as ELL in both orientations: prolong and restrict are one flat row
gather each (the JAX package gathers one ELL column at a time on levels
of 8192 rows or more, a TPU layout choice).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from parmgmc_tpu_torch import resolve_device

from parmgmc_tpu_torch.operators import stencil as _st

__all__ = ["AggregateTransfer", "GeometricTransfer", "SparseTransfer", "sparse_transfer_from_csr"]


@dataclass(frozen=True)
class GeometricTransfer:
    """Vertex-style linear interpolation from ceil(n/2) points an axis
    and its exact transpose.  ``impl`` ``"kernel"`` lets
    :meth:`prolong_add` launch the prolong-add kernel where it takes the
    call; ``"torch"`` keeps the plain expression
    (``samplers.registry.lax_variant``)."""

    fine_shape: tuple
    impl: str = "kernel"

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        return _st.prolong(xc, self.fine_shape)

    def restrict(self, xf: torch.Tensor) -> torch.Tensor:
        return _st.restrict(xf, len(self.fine_shape))

    def prolong_add(self, y: torch.Tensor, xc: torch.Tensor, out=None) -> torch.Tensor:
        """y + prolong(xc), into ``out`` when given: one launch of the
        prolong-add kernel where y is on the card and
        ``kernels.prolong_add.takes`` the call (a 3D float32 grid with no
        chain dims), else the same expression in plain torch (its twin)."""
        if self.impl == "kernel" and y.device.type == "cuda":
            # the kernel modules import the operators (kernels.residual_restrict
            # imports this one), never the reverse at import time
            from parmgmc_tpu_torch.kernels import prolong_add as pa

            if pa.takes(y, xc, self.fine_shape, out):
                return pa.prolong_add(y.contiguous(), xc.contiguous(), out=out)
        return torch.add(y, self.prolong(xc), out=out)


def _agg_up_1d(c: torch.Tensor, axis: int, nf: int) -> torch.Tensor:
    c = torch.movedim(c, axis, -1)
    m = nf // 2
    main = c[..., :m, None].expand(*c.shape[:-1], m, 2).reshape(*c.shape[:-1], 2 * m)
    if nf % 2:  # odd: last coarse cell covers a single fine node
        main = torch.cat([main, c[..., m:]], dim=-1)
    return torch.movedim(main, -1, axis)


def _agg_down_1d(f: torch.Tensor, axis: int) -> torch.Tensor:
    f = torch.movedim(f, axis, -1)
    nf = f.shape[-1]
    m = nf // 2
    fp = f[..., : 2 * m].reshape(*f.shape[:-1], m, 2)
    pair = fp[..., 0] + fp[..., 1]
    if nf % 2:
        pair = torch.cat([pair, f[..., 2 * m :]], dim=-1)
    return torch.movedim(pair, -1, axis)


@dataclass(frozen=True)
class AggregateTransfer:
    """Piecewise-constant aggregation over 2^d cell blocks (grid in the
    leading ``len(fine_shape)`` dims)."""

    fine_shape: tuple

    def _even(self) -> bool:
        return all(s % 2 == 0 for s in self.fine_shape)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        if self._even():
            d = len(self.fine_shape)
            rest = tuple(xc.shape[d:])
            v = xc.reshape(*itertools.chain.from_iterable((s, 1) for s in xc.shape[:d]), *rest)
            v = v.expand(*itertools.chain.from_iterable((s, 2) for s in xc.shape[:d]), *rest)
            return v.reshape(*self.fine_shape, *rest)
        y = xc
        for axis, nf in enumerate(self.fine_shape):
            y = _agg_up_1d(y, axis, nf)
        return y

    def restrict(self, xf: torch.Tensor) -> torch.Tensor:
        y = xf
        for axis in range(len(self.fine_shape)):
            y = _agg_down_1d(y, axis)
        return y

    def prolong_add(self, y: torch.Tensor, xc: torch.Tensor, out=None) -> torch.Tensor:
        """y + P xc in one broadcast pass on even grids (the same single
        add per element as ``y + prolong(xc)``, so the same bits), into
        ``out`` (contiguous) when given."""
        if not self._even() or y.ndim != len(self.fine_shape):
            return torch.add(y, self.prolong(xc), out=out)
        split = tuple(itertools.chain.from_iterable((s // 2, 2) for s in self.fine_shape))
        cview = itertools.chain.from_iterable((s, 1) for s in xc.shape)
        dst = None if out is None else out.view(split)
        return torch.add(y.reshape(split), xc.reshape(*cview), out=dst).reshape(self.fine_shape)


def _ell_apply(vals, cols, x):
    """sum_k vals[:, k] x[cols[:, k]]; x is (n,) or chain-major (n, C)."""
    g = x[cols]
    v = vals if g.ndim == 2 else vals[..., None]
    return (v * g).sum(dim=1)


@dataclass(frozen=True, eq=False)
class SparseTransfer:
    """P (nf x nc) as row-gather ELL in both orientations; applies accept
    the chain axis ((n, C), chain-major)."""

    p_vals: torch.Tensor  # (nf, w)
    p_cols: torch.Tensor  # (nf, w) int64 into coarse
    pt_vals: torch.Tensor  # (nc, wt)
    pt_cols: torch.Tensor  # (nc, wt) int64 into fine

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        return _ell_apply(self.p_vals, self.p_cols, xc)

    def restrict(self, xf: torch.Tensor) -> torch.Tensor:
        return _ell_apply(self.pt_vals, self.pt_cols, xf)

    def prolong_add(self, y: torch.Tensor, xc: torch.Tensor, out=None) -> torch.Tensor:
        return torch.add(y, self.prolong(xc), out=out)


def _ell_from_csr(M):
    """(vals, cols) of a scipy matrix in ELL, padded as the JAX package
    pads (zero values, the row's first column)."""
    import scipy.sparse as sp

    M = sp.csr_matrix(M)
    n = M.shape[0]
    counts = np.diff(M.indptr)
    w = max(1, int(counts.max()))
    rows = np.repeat(np.arange(n), counts)
    pos = np.arange(M.nnz) - M.indptr[rows]
    vals = np.zeros((n, w))
    cols = np.zeros((n, w), dtype=np.int64)
    vals[rows, pos] = M.data
    cols[rows, pos] = M.indices
    first = np.where(counts > 0, M.indices[np.minimum(M.indptr[:-1], max(M.nnz - 1, 0))], 0)
    pad = np.arange(w)[None, :] >= counts[:, None]
    cols = np.where(pad, first[:, None], cols)
    return vals, cols


def sparse_transfer(p_vals, p_cols, pt_vals, pt_cols, dtype=torch.float64, device=None) -> SparseTransfer:
    """A SparseTransfer from host ELL arrays, on ``device`` (the card when None)."""
    dev = resolve_device(device)

    def t(a, dt):
        return torch.as_tensor(np.array(a), device=dev).to(dt)

    return SparseTransfer(p_vals=t(p_vals, dtype), p_cols=t(p_cols, torch.int64),
                          pt_vals=t(pt_vals, dtype), pt_cols=t(pt_cols, torch.int64))


def sparse_transfer_from_csr(P, dtype=torch.float64, device=None) -> SparseTransfer:
    """The transfer of the scipy prolongation P (nf x nc)."""
    pv, pc = _ell_from_csr(P)
    tv, tc = _ell_from_csr(P.T)
    return sparse_transfer(pv, pc, tv, tc, dtype, device)
