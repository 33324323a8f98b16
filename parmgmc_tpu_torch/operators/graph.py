"""Sparse graph operators for unstructured meshes (port of
``parmgmc_tpu.operators.graph``: ``GraphOperator``, ``greedy_coloring``,
``from_csr``).

Rows are stored in fixed-width ELL form -- ``vals (n, w)`` off-diagonal
values (zero-padded), ``cols (n, w)`` column ids (padded with the row's
own id) -- and the unknowns are permuted at set-up so that the colours of
a greedy distance-1 colouring are contiguous row blocks, rows sorted by
descending off-diagonal degree within a colour.  One colour of a
multicolour SOR sweep is then a gather over a static row slice and a
write of that slice.

Every linear-algebra entry point accepts ``x`` of shape ``(n,)`` or the
chain-major ``(n, C)``: C independent chains, each gathered neighbour a
contiguous C-wide row.

The JAX package gathers column k of a colour block only over the rows
that have a k-th neighbour (``color_counts``, from 8192 rows), a TPU
byte-layout choice that costs one gather per ELL column.  Eager torch
pays a launch for each op, so here a colour's update is ONE flat gather
``x[cols[s:e, :w_c]]`` of the block's own widest row w_c
(``len(color_counts[c])``); ``color_counts`` is kept as data.  The flat
gather sums a row in another order than JAX's prefix path, so the two
agree to roundoff, not bit for bit.

The operator presents the protocol of the stencil operators with
``grid_shape == (n,)``: the Gibbs, Cholesky, MGMC, LRC and Woodbury
samplers and the invariance oracle take it unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from parmgmc_tpu_torch import native, resolve_device
from parmgmc_tpu_torch.profiling import span

__all__ = ["GraphOperator", "greedy_coloring", "greedy_coloring_py", "ell_pack_py", "from_csr"]


def bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``v`` (per row) with singleton axes appended to match the trailing
    chain dims of ``x`` (n, C)."""
    if x.ndim > v.ndim:
        return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))
    return v


def greedy_coloring_py(indptr, indices, n: int) -> np.ndarray:
    """Greedy distance-1 colouring in natural order: the Python twin of
    the native routine."""
    colors = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        nb = indices[indptr[i] : indptr[i + 1]]
        used = set(colors[j] for j in nb if colors[j] >= 0)
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


def greedy_coloring(indptr, indices, n: int) -> np.ndarray:
    """Greedy distance-1 colouring (natural order) of a symmetric graph,
    by the native routine (bit for bit :func:`greedy_coloring_py`)."""
    return native.greedy_coloring(indptr, indices, n)


def ell_pack_py(indptr, indices, data, n: int, w: int):
    """The Python twin of the native ELL pack."""
    vals = np.zeros((n, w))
    cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, w))
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        vals[i, : hi - lo] = data[lo:hi]
        cols[i, : hi - lo] = indices[lo:hi]
    return vals, cols


@dataclass(frozen=True, eq=False)
class GraphOperator:
    """Symmetric sparse operator in colour-blocked, degree-sorted ELL form."""

    vals: torch.Tensor  # (n, w) off-diagonal values (0-padded)
    cols: torch.Tensor  # (n, w) int64 column ids (self-padded)
    diag: torch.Tensor  # (n,)
    perm: torch.Tensor  # (n,) original -> internal: internal[i] = orig[perm[i]]
    iperm: torch.Tensor  # (n,) inverse permutation
    color_starts: tuple  # row offsets of the colour blocks (ncolors + 1)
    # color_counts[c][k]: rows of colour c with degree > k, rounded up to a
    # multiple of 8 (the JAX package's prefix counts); len() is the block's
    # widest row
    color_counts: tuple = ()

    def __post_init__(self):
        # (s, e, vals, cols) of each non-empty colour block at its own width
        blocks = []
        w = self.vals.shape[1]
        for c in range(self.ncolors):
            s, e = self.color_starts[c], self.color_starts[c + 1]
            if s == e:
                continue
            wc = len(self.color_counts[c]) if self.color_counts else w
            blocks.append((s, e, self.vals[s:e, :wc].contiguous(), self.cols[s:e, :wc].contiguous()))
        object.__setattr__(self, "blocks", tuple(blocks))

    @property
    def grid_shape(self):
        return (self.diag.shape[0],)

    @property
    def ndim(self) -> int:
        return 1

    @property
    def n(self) -> int:
        return self.diag.shape[0]

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    @property
    def ncolors(self) -> int:
        return len(self.color_starts) - 1

    @staticmethod
    def _row_dot(vals, g):
        """sum_k vals[:, k] g[:, k] for a gather g (m, w[, C])."""
        return (bcast(vals, g) * g).sum(dim=1)

    # -- linear algebra ------------------------------------------------------
    def offdiag_apply(self, x: torch.Tensor) -> torch.Tensor:
        """(A - D) x by one flat gather; x is (n,) or (n, C)."""
        return self._row_dot(self.vals, x[self.cols])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return bcast(self.diag, x) * x + self.offdiag_apply(x)

    def to_dense(self) -> torch.Tensor:
        n = self.n
        A = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        rows = torch.arange(n, device=self.device)[:, None].expand_as(self.cols)
        A.index_put_((rows, self.cols), self.vals, accumulate=True)
        return A + torch.diag(self.diag)

    # -- multicolour SOR sweep -----------------------------------------------
    def sor_sweep(self, b, x, omega: float, sweep: str = "forward"):
        """One multicolour SOR sweep, colour by colour in block order
        (backward: reversed); ``x`` and ``b`` may carry the chain axis
        (a ``b`` of shape (n,) is shared by every chain).  Returns a new
        tensor; ``x`` is not written."""
        if sweep == "symmetric":
            x = self.sor_sweep(b, x, omega, "forward")
            return self.sor_sweep(b, x, omega, "backward")
        with span("pmg.graph.sor_sweep"):
            x = x.clone()
            order = self.blocks if sweep == "forward" else reversed(self.blocks)
            for s, e, vals, cols in order:
                acc = bcast(b[s:e], x) - self._row_dot(vals, x[cols])
                x[s:e] = (1.0 - omega) * x[s:e] + bcast(omega / self.diag[s:e], x) * acc
        return x

    def to_csr(self):
        """scipy CSR of the operator in INTERNAL (colour-blocked) order,
        float64, on the host (set-up only)."""
        return ell_csr(self, np.float64)

    # -- permutation helpers -------------------------------------------------
    def to_internal(self, v_orig):
        return v_orig[self.perm]

    def to_original(self, v_int):
        return v_int[self.iperm]


def ell_csr(g: GraphOperator, dtype=None):
    """scipy CSR of ``g`` in internal order, assembled as the JAX package's
    hierarchy builders assemble it (ELL entries, then ``setdiag``), in the
    operator's own precision unless ``dtype`` is given.  Set-up only."""
    import scipy.sparse as sp

    n = g.n
    vals = g.vals.detach().cpu().numpy()
    diag = g.diag.detach().cpu().numpy()
    if dtype is not None:
        vals, diag = vals.astype(dtype), diag.astype(dtype)
    rows = np.repeat(np.arange(n), g.cols.shape[1])
    A = sp.csr_matrix((vals.ravel(), (rows, g.cols.cpu().numpy().ravel())), shape=(n, n))
    A.setdiag(diag)
    A.eliminate_zeros()
    return A


def graph_operator(vals, cols, diag, perm, iperm, color_starts, color_counts=(),
                   dtype=torch.float64, device=None) -> GraphOperator:
    """A GraphOperator from host arrays, on ``device`` (the card when None)."""
    dev = resolve_device(device)

    def idx(a):
        return torch.as_tensor(np.array(a, dtype=np.int64), device=dev)

    return GraphOperator(
        vals=torch.as_tensor(np.array(vals), device=dev).to(dtype),
        cols=idx(cols),
        diag=torch.as_tensor(np.array(diag), device=dev).to(dtype),
        perm=idx(perm),
        iperm=idx(iperm),
        color_starts=tuple(int(s) for s in color_starts),
        color_counts=tuple(tuple(int(v) for v in cc) for cc in color_counts),
    )


def from_csr(A_csr, dtype=torch.float64, device=None) -> GraphOperator:
    """A colour-blocked, degree-sorted GraphOperator from scipy CSR, on
    ``device`` (the card when None): the JAX ``from_csr``'s colours,
    permutation, blocks and ELL arrays exactly."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A_csr)
    n = A.shape[0]
    colors = greedy_coloring(A.indptr, A.indices, n)
    ncolors = int(colors.max()) + 1
    perm = np.argsort(colors, kind="stable").astype(np.int32)

    counts = np.bincount(colors, minlength=ncolors)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(int)

    # off-diagonal degree of each ORIGINAL node
    Ad = A - sp.diags(A.diagonal())
    Ad.eliminate_zeros()
    deg = np.diff(Ad.tocsr().indptr)

    # within each colour, rows by descending degree (stable)
    order = np.concatenate([
        starts[c] + np.argsort(-deg[perm[starts[c] : starts[c + 1]]], kind="stable")
        for c in range(ncolors)
    ]).astype(np.int32)
    perm = perm[order]
    iperm = np.empty(n, dtype=np.int32)
    iperm[perm] = np.arange(n, dtype=np.int32)

    color_counts = []
    for c in range(ncolors):
        s, e = starts[c], starts[c + 1]
        dc = np.sort(deg[perm[s:e]])[::-1] if e > s else np.zeros(0, int)
        wc = int(dc[0]) if e > s and dc.size else 0
        color_counts.append(tuple(
            int(min(e - s, -(-int((dc > k).sum()) // 8) * 8)) for k in range(wc)
        ))

    # P A P^T in internal order
    Ap = A[perm][:, perm].tocsr()
    diag = Ap.diagonal().copy()
    Aoff = Ap - sp.diags(diag)
    Aoff.eliminate_zeros()
    Aoff = Aoff.tocsr()
    w = max(1, int(np.diff(Aoff.indptr).max()))
    vals, cols = native.ell_pack(Aoff.indptr, Aoff.indices, Aoff.data, n, w)
    return graph_operator(vals, cols, diag, perm, iperm, starts, color_counts, dtype, device)
