"""Structured-grid transfers (port of ``GeometricTransfer`` and
``AggregateTransfer`` in ``parmgmc_tpu.operators.transfer``).

Both implement ``prolong(xc) -> xf``, ``restrict(xf) -> xc`` with
restrict = prolong^T and ``prolong_add(y, xc) = y + prolong(xc)``, the
grid in the leading ``len(fine_shape)`` dims.

:class:`GeometricTransfer` is the linear interpolation and full weighting
of :mod:`parmgmc_tpu_torch.operators.stencil` (``coarsening="linear"``,
the default hierarchy).  In :class:`AggregateTransfer` P injects each
coarse value into its 2^d fine block (an odd extent's last coarse cell
covers one fine node); R = P^T sums the block.  Sums
take the axis-0 pair first, then axis 1, then axis 2 -- the order the
CUDA kernels use for their fused restriction.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch

from parmgmc_tpu_torch.operators import stencil as _st

__all__ = ["AggregateTransfer", "GeometricTransfer"]


@dataclass(frozen=True)
class GeometricTransfer:
    """Vertex-style linear interpolation from ceil(n/2) points an axis
    and its exact transpose."""

    fine_shape: tuple

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        return _st.prolong(xc, self.fine_shape)

    def restrict(self, xf: torch.Tensor) -> torch.Tensor:
        return _st.restrict(xf, len(self.fine_shape))

    def prolong_add(self, y: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
        return y + self.prolong(xc)


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

    def prolong_add(self, y: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
        """y + P xc in one broadcast pass on even grids (the same single
        add per element as ``y + prolong(xc)``, so the same bits)."""
        if not self._even() or y.ndim != len(self.fine_shape):
            return y + self.prolong(xc)
        split = itertools.chain.from_iterable((s // 2, 2) for s in self.fine_shape)
        cview = itertools.chain.from_iterable((s, 1) for s in xc.shape)
        return (y.reshape(*split) + xc.reshape(*cview)).reshape(self.fine_shape)
