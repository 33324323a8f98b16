"""Algebraic (smoothed-aggregation) multigrid hierarchy for graph
operators (port of ``parmgmc_tpu.operators.aggregation``).

Set-up runs on the host with scipy.sparse; each level goes to the device
as a colour-blocked :class:`~parmgmc_tpu_torch.operators.graph.
GraphOperator` and a gather-only :class:`~parmgmc_tpu_torch.operators.
transfer.SparseTransfer`.  Per level:

  1. strength graph  S = { (i,j) : |a_ij| > theta * sqrt(a_ii a_jj) },
  2. greedy aggregation (MIS-style) on S (the native routine),
  3. tentative prolongator P0, piecewise constant over the aggregates,
  4. smoothing  P = (I - omega D^{-1} A) P0,
  5. Galerkin   A_c = P^T A P  (exact, scipy sparse triple product).

A_c = P^T A P exactly, so the MGMC invariance argument holds level by
level (the invariance tests check it to machine precision).
"""

from __future__ import annotations

import numpy as np

from parmgmc_tpu_torch import native
from parmgmc_tpu_torch.operators.graph import GraphOperator, ell_csr, from_csr
from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.operators.transfer import sparse_transfer_from_csr

__all__ = ["aggregation_hierarchy", "smoothed_aggregation_level", "aggregate_py"]


def _strength_graph(A, theta):
    import scipy.sparse as sp

    d = np.sqrt(np.maximum(A.diagonal(), 1e-300))
    C = sp.csr_matrix(A, copy=True)
    C.setdiag(0.0)
    C.eliminate_zeros()
    coo = C.tocoo()
    keep = np.abs(coo.data) > theta * d[coo.row] * d[coo.col]
    return sp.csr_matrix((np.ones(keep.sum()), (coo.row[keep], coo.col[keep])), shape=A.shape)


def aggregate_py(S):
    """Greedy aggregation of the strength graph S: roots form a maximal
    independent set and take their neighbours, stragglers join an
    aggregated strong neighbour or start their own.  The Python twin of
    the native routine: (agg (n,) int64, n_agg)."""
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = S.indices[S.indptr[i] : S.indptr[i + 1]]
        if np.all(agg[nb] < 0):
            agg[i] = n_agg
            agg[nb] = n_agg
            n_agg += 1
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = S.indices[S.indptr[i] : S.indptr[i + 1]]
        hit = nb[agg[nb] >= 0]
        if hit.size:
            agg[i] = agg[hit[0]]
        else:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def smoothed_aggregation_level(A, theta=0.02, omega=2.0 / 3.0, nsmooth=1):
    """One coarsening step: (P, A_coarse) as scipy CSR."""
    import scipy.sparse as sp

    n = A.shape[0]
    S = _strength_graph(A, theta)
    agg, n_agg = native.aggregate(S.indptr, S.indices, n)  # bit for bit aggregate_py
    P = sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, n_agg))
    if nsmooth:
        Sm = sp.eye(n) - omega * (sp.diags(1.0 / A.diagonal()) @ A)
        for _ in range(nsmooth):
            P = Sm @ P
        P = sp.csr_matrix(P)
    Ac = sp.csr_matrix(P.T @ A @ P)
    Ac.eliminate_zeros()
    return P, Ac


def aggregation_hierarchy(op, n_levels=None, coarsest_size: int = 128, theta: float = 0.02,
                          nsmooth: int = 1):
    """(ops, transfers) for a GraphOperator (or LRC over one), each level
    on the operator's device.  Transfers are expressed in each level's
    internal (colour-blocked) ordering; on an LRC operator every level
    is LRC with B_c = P^T B."""
    import scipy.sparse as sp

    is_lrc = isinstance(op, LRCOperator)
    base0 = op.base if is_lrc else op
    if not isinstance(base0, GraphOperator):
        raise TypeError(f"aggregation_hierarchy needs a GraphOperator, got {type(base0).__name__}")
    dtype, dev = base0.dtype, base0.device

    ops = [op]
    transfers = []
    A = ell_csr(base0)
    while True:
        if n_levels is not None and len(ops) >= n_levels:
            break
        if n_levels is None and A.shape[0] <= coarsest_size:
            break
        P, Ac = smoothed_aggregation_level(A, theta=theta, nsmooth=nsmooth)
        if Ac.shape[0] >= A.shape[0]:  # no coarsening progress
            break
        coarse = from_csr(Ac, dtype=dtype, device=dev)
        # P's rows are in the fine level's internal ordering already (A is
        # kept in the current level's internal ordering); the columns take
        # the coarse level's permutation
        pc = coarse.perm.cpu().numpy()
        tr = sparse_transfer_from_csr(sp.csr_matrix(P[:, pc]), dtype=dtype, device=dev)
        transfers.append(tr)
        if is_lrc:
            ops.append(ops[-1].coarsened(coarse, tr))
        else:
            ops.append(coarse)
        # go on in the COARSE level's internal ordering: the next level's P
        # rows must be built in the coordinates the coarse operator works
        # in (the JAX package records that the unpermuted A_c broke
        # Galerkin exactness for every hierarchy of 3 or more levels)
        A = sp.csr_matrix(Ac[pc][:, pc])
    return ops, tuple(transfers)
