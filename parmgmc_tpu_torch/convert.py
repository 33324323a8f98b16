"""Carry operators, factors, samplers and chain state across from numpy.

The JAX package and this port hold the same objects in different array
types.  These constructors build the port's side from plain numpy
arrays (which a caller pulls out of the JAX objects with ``np.asarray``),
so both packages can run on the very same numbers:

* an operator from (kappa2, hinv2) or from (offsets, coeffs, diag), or
  from any object that holds those three (a JAX ``StencilOperator`` with
  scalar or field coefficients),
* the linear grid transfer of a fine shape,
* a Cholesky coarse sampler from its factor ``L`` and inverse ``Li``,
* an MGMC sampler from its per-level operators, the coarse factors and
  the coarsening,
* a patch-Gibbs sampler from its operator and squared-FD parameters,
* an LRC operator from its base, B, Sigma^{-1} and patch view, and a
  Woodbury sampler from its prior sampler and factors,
* the deferred chain carry ``z`` in the port's compact layout from
  either JAX layout (``zx2`` and ``zf``), or the posterior's (z, B^T x)
  pair,
* noise trees of numpy arrays,
* the unstructured-mesh objects, from any object holding the JAX
  fields (read with ``np.asarray``): a graph operator, a sparse
  transfer, an LRC operator over a graph, an MGMC sampler over a graph
  hierarchy, and a graph patch-Gibbs sampler.
"""

from __future__ import annotations

import numpy as np
import torch

from parmgmc_tpu_torch import resolve_device
from parmgmc_tpu_torch.operators import graph as _graph
from parmgmc_tpu_torch.operators import transfer as _transfer
from parmgmc_tpu_torch.operators.lrc import Columns, LRCOperator
from parmgmc_tpu_torch.operators.stencil import StencilOperator, fd_stencil
from parmgmc_tpu_torch.operators.transfer import AggregateTransfer, GeometricTransfer
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
from parmgmc_tpu_torch.samplers.patch_gibbs import GraphPatchGibbsSampler, PatchGibbsSampler, star_patch
from parmgmc_tpu_torch.samplers.woodbury import WoodburySampler

__all__ = [
    "tensor",
    "tree",
    "fd_operator",
    "stencil_operator",
    "stencil_operator_from",
    "geometric_transfer",
    "cholesky_sampler",
    "mgmc_sampler",
    "patch_gibbs_sampler",
    "lrc_operator",
    "woodbury_sampler",
    "deferred_carry_from_jax",
    "graph_operator",
    "sparse_transfer",
    "graph_lrc_operator",
    "graph_mgmc_sampler",
    "graph_patch_gibbs_sampler",
]


def tensor(a, device=None, dtype=None) -> torch.Tensor:
    """A numpy array (or scalar) as a contiguous tensor on ``device`` (the
    card when None)."""
    t = torch.from_numpy(np.array(a, order="C"))  # a writable copy, 0-d kept
    return t.to(device=resolve_device(device), dtype=dtype or t.dtype)


def tree(noises, device=None):
    """A tree (dicts, lists) of numpy arrays as the same tree of tensors."""
    if isinstance(noises, dict):
        return {k: tree(v, device) for k, v in noises.items()}
    if isinstance(noises, (list, tuple)):
        return [tree(v, device) for v in noises]
    return tensor(noises, device)


def fd_operator(kappa2, hinv2, grid_shape, dtype=torch.float32, device=None, lazy="auto"):
    """Link-count FD operator from its two scalars."""
    return fd_stencil(grid_shape, float(kappa2), float(hinv2), dtype=dtype, device=device, lazy=lazy)


def stencil_operator(offsets, coeffs, diag, device=None) -> StencilOperator:
    """Operator from a stencil field: coefficients are numpy scalars or
    grid-shaped arrays."""
    d = tensor(diag, device)
    return StencilOperator(
        offsets=tuple(tuple(int(o) for o in off) for off in offsets),
        coeffs=tuple(tensor(c, device, d.dtype) for c in coeffs),
        diag=d,
    )


def stencil_operator_from(op, device=None) -> StencilOperator:
    """The port's operator from any object with ``offsets``, ``coeffs``
    and ``diag`` (a JAX ``StencilOperator``: each coefficient a scalar
    or a grid-shaped field), read with ``np.asarray``."""
    return stencil_operator(op.offsets, [np.asarray(c) for c in op.coeffs], np.asarray(op.diag), device)


def geometric_transfer(fine_shape) -> GeometricTransfer:
    """The linear transfer (``coarsening="linear"``) of a fine grid."""
    return GeometricTransfer(fine_shape=tuple(int(s) for s in fine_shape))


def cholesky_sampler(L, Li, grid_shape, device=None) -> CholeskySampler:
    return CholeskySampler.from_factors(
        tensor(L, device), None if Li is None else tensor(Li, device), grid_shape
    )


def mgmc_sampler(ops, L, Li, *, omega=1.0, sweep="forward", n_pre=1, n_post=1,
                 n_coarse=1, gamma=1, coarsening="aggregate", device=None) -> MGMCSampler:
    """MGMC sampler over the given per-level operators (finest first), the
    transfers of ``coarsening`` between them and a Cholesky coarse sampler
    from (L, Li)."""
    ops = list(ops)
    if coarsening not in ("linear", "aggregate"):
        raise ValueError(f"unknown coarsening {coarsening!r} (linear or aggregate)")
    transfers = [geometric_transfer(o.grid_shape) if coarsening == "linear"
                 else AggregateTransfer(fine_shape=tuple(o.grid_shape)) for o in ops[:-1]]
    coarse = cholesky_sampler(L, Li, ops[-1].grid_shape, device)
    return MGMCSampler.from_levels(
        ops, transfers, coarse, omega=omega, sweep=sweep, n_pre=n_pre,
        n_post=n_post, n_coarse=n_coarse, gamma=gamma,
    )


def patch_gibbs_sampler(offsets, coeffs, diag, sq_fd_params, device=None) -> PatchGibbsSampler:
    """Patch-Gibbs sampler over the stencil operator (offsets, coeffs,
    diag); ``sq_fd_params`` is the JAX sampler's (kappa2, hinv2) of F, or
    None for the explicit-noise step."""
    op = stencil_operator(offsets, coeffs, diag, device)
    sq = None if sq_fd_params is None else tuple(float(np.float32(v)) for v in np.asarray(sq_fd_params))
    return PatchGibbsSampler(
        base=op, patch_offsets=star_patch(op.ndim), ncolor_base=op.radius + 3, sq_fd_params=sq
    )


def lrc_operator(base, B, sigma_inv, patch_vals=None, patch_starts=None, device=None) -> LRCOperator:
    """LRC operator over the port operator ``base`` from numpy B (*grid, k),
    Sigma^{-1} (k,) and, optionally, the JAX operator's window view
    (values (k, *box), starts (k, ndim))."""
    B = tensor(B, device)
    cols = None if patch_vals is None else Columns(
        B, tensor(patch_vals, device), tuple(tuple(int(v) for v in st) for st in np.asarray(patch_starts)))
    return LRCOperator(base=base, B=B, sigma_inv=tensor(sigma_inv, device), cols=cols)


def woodbury_sampler(sampler, B, sqrt_sigma_inv, G, device=None) -> WoodburySampler:
    """Woodbury sampler around the port sampler ``sampler`` from numpy B,
    sqrt(Sigma^{-1}) and G (*grid, k)."""
    return WoodburySampler(sampler=sampler, B=tensor(B, device),
                           sqrt_sigma_inv=tensor(sqrt_sigma_inv, device), G=tensor(G, device))


def deferred_carry_from_jax(z, layout, device=None):
    """The port's compact carry (N0/2, N1/2, N2/2) from a JAX deferred
    carry: ``layout="zx2"`` (N0/2, N1/2, N2), lanes duplicated, as the
    whole-plane and staged kernels take it; ``layout="zf"`` (N0/2, N1,
    N2), only axis 0 compressed, as the 2D kernels take it.  The probed
    posterior's pair (z, B^T x) comes across as the pair (carry, B^T x)."""
    if isinstance(z, tuple):
        return deferred_carry_from_jax(z[0], layout, device), tensor(z[1], device)
    z = np.asarray(z)
    if layout == "zx2":
        return tensor(z[..., ::2], device)
    if layout == "zf":
        return tensor(z[:, ::2, ::2], device)
    raise ValueError(f"unknown deferred carry layout {layout!r} (zx2 or zf)")


def _dtype_of(a) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.asarray(a).dtype)).dtype


def graph_operator(g, device=None):
    """The port's GraphOperator from an object with the JAX fields (vals,
    cols, diag, perm, iperm, color_starts, color_counts)."""
    vals = np.asarray(g.vals)
    return _graph.graph_operator(
        vals, np.asarray(g.cols), np.asarray(g.diag), np.asarray(g.perm), np.asarray(g.iperm),
        g.color_starts, g.color_counts, dtype=_dtype_of(vals), device=device,
    )


def sparse_transfer(t, device=None):
    """The port's SparseTransfer from an object with the JAX fields
    (p_vals, p_cols, pt_vals, pt_cols)."""
    pv = np.asarray(t.p_vals)
    return _transfer.sparse_transfer(pv, np.asarray(t.p_cols), np.asarray(t.pt_vals),
                                     np.asarray(t.pt_cols), dtype=_dtype_of(pv),
                                     device=device)


def graph_lrc_operator(op, device=None) -> LRCOperator:
    """The port's LRC operator over a graph from a JAX LRCOperator whose
    base is a graph operator (B (n, k) in internal order, no patch view)."""
    return LRCOperator(base=graph_operator(op.base, device), B=tensor(np.asarray(op.B), device),
                       sigma_inv=tensor(np.asarray(op.sigma_inv), device))


def _graph_level(op, device):
    return graph_lrc_operator(op, device) if hasattr(op, "B") else graph_operator(op, device)


def graph_mgmc_sampler(smp, device=None) -> MGMCSampler:
    """The port's MGMC sampler over the graph hierarchy of a JAX sampler:
    its levels, transfers and dense Cholesky coarse factors, Gibbs
    smoothers with each JAX smoother's omega and sweep (graph patch-Gibbs
    smoothers carried across as they are), and its cycle shape."""
    ops = [_graph_level(o, device) for o in smp.ops]
    transfers = [sparse_transfer(t, device) for t in smp.transfers]
    smoothers = []
    for o, s in zip(ops[:-1], smp.smoothers):
        if hasattr(s, "color_sets"):
            smoothers.append(graph_patch_gibbs_sampler(s, device, o.base if hasattr(o, "B") else o))
        else:
            smoothers.append(GibbsSampler.create(o, omega=float(np.asarray(s.omega)), sweep=s.sweep))
    Li = smp.coarse.Li
    coarse = cholesky_sampler(np.asarray(smp.coarse.L), None if Li is None else np.asarray(Li),
                              ops[-1].grid_shape, device)
    return MGMCSampler.from_levels(ops, transfers, coarse, n_pre=smp.n_pre, n_post=smp.n_post,
                                   n_coarse=smp.n_coarse, gamma=smp.gamma, smoothers=smoothers)


def graph_patch_gibbs_sampler(s, device=None, op=None) -> GraphPatchGibbsSampler:
    """The port's graph patch-Gibbs sampler from a JAX one: its members,
    mask and colour sets (sentinel padding dropped), over ``op`` (the
    sampler's own base carried across when None)."""
    op = op if op is not None else graph_operator(s.base, device)
    members = np.asarray(s.members)[:-1].astype(np.int64)
    mask = np.asarray(s.member_mask)[:-1] > 0.5
    n = members.shape[0]
    sets = [cs[cs < n] for cs in np.asarray(s.color_sets)]
    return GraphPatchGibbsSampler.from_sets(op, members, mask, sets)
