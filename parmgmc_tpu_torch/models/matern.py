"""Matérn random-field sampler façades (port of ``parmgmc_tpu.models.matern``).

:class:`MaternSampler` samples the structured-grid Whittle-Matérn field
with precision kappa^2 - Laplace (``shifted_laplace_fd``) through an MGMC
chain: ``sample`` streams a QOI, ``sample_mean_and_var`` records moments,
``sample_chains`` runs many independent chains (the reference's MS
object).

Given a Gmsh mesh (or points and cells), optional uniform refinements and
kappa, :class:`MaternMeshSampler` assembles the P1 (or CG2) precision
kappa^2 M + K, builds the MGMC chain on the algebraic (smoothed
aggregation) or geometric (refinement chain) hierarchy and, with
ball-average observations, samples the posterior through an LRC operator.
Every vector given to the user is in the mesh's original node order; the
colour-blocked internal order stays inside.

Many chains run chain-major on the graph samplers (:func:`
batched_chains_supported`): one state x of shape (n, C), one keyed step
advancing every chain.  Every other sampler runs them one at a time
through :func:`~parmgmc_tpu_torch.chain.multi_chain` (the JAX package
vmaps a leading chain axis), so a kernel sampler runs its kernels.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from parmgmc_tpu_torch import keys, resolve_device
from parmgmc_tpu_torch.chain import ChainState, init_chain, multi_chain, sample_chain, sample_moments
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

__all__ = ["MaternMeshSampler", "MaternSampler", "batched_chains_supported", "observations_of", "region_qoi"]


def observations_of(preset: dict):
    """The ``observations`` dict of a benchmark preset (the JSON files of
    ``examples/benchmark/``: ``sigma2``, ``obs_coords``, ``obs_radii``,
    ``obs_values``), or None for a prior preset."""
    if not preset.get("posterior"):
        return None
    return dict(sigma2=float(preset["sigma2"]), coords=preset["obs_coords"], radii=preset["obs_radii"],
                values=preset["obs_values"])


def region_qoi(points, preset: dict):
    """Weights (n,) in ORIGINAL node order of the mean over a preset's QOI
    region (``qoi_type`` "rect": ``qoi_start``..``qoi_end``; "sphere":
    ``qoi_centre``, ``qoi_radius``), as a float64 numpy vector, or None
    when the preset names no region or the region holds no node."""
    import numpy as np

    d = points.shape[1]
    if preset.get("qoi_type") == "rect":
        lo = np.asarray(preset["qoi_start"], float)[:d]
        hi = np.asarray(preset["qoi_end"], float)[:d]
        m = np.all((points >= lo) & (points <= hi), axis=1)
    elif preset.get("qoi_type") == "sphere":
        c = np.asarray(preset["qoi_centre"], float)[:d]
        m = ((points - c) ** 2).sum(axis=1) <= preset["qoi_radius"] ** 2
    else:
        return None
    if not m.any():
        return None
    return m / m.sum()


class MaternSampler:
    """Gaussian random fields with the Matérn-type precision kappa^2 -
    Laplace on a structured grid (``shifted_laplace_fd``), zero mean.

    ``sampler`` replaces the default ``MGMCSampler.create(op,
    **mgmc_kwargs)``.  The operator and the chain live on ``device`` (the
    card when None)."""

    def __init__(self, grid_shape, kappa: float = 1.0, dtype=torch.float32, seed: int = 0,
                 sampler: Optional[object] = None, device=None, **mgmc_kwargs):
        from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd

        self.grid_shape = tuple(grid_shape)
        self.kappa = float(kappa)
        self.op = shifted_laplace_fd(self.grid_shape, kappa, dtype=dtype, device=resolve_device(device))
        self.sampler = sampler or MGMCSampler.create(self.op, **mgmc_kwargs)
        self.state = init_chain(self.sampler, int(seed))
        self.b = torch.zeros(self.grid_shape, dtype=dtype, device=self.op.device)  # zero-mean field
        self._qoi: Optional[Callable] = None
        self._chain_states = {}

    def set_qoi(self, fn: Callable):
        """The QOI applied to each sample (the reference's MSSetQOI)."""
        self._qoi = fn

    def sample(self, n: int = 1, burnin: int = 0):
        """Advance the chain n steps (after ``burnin``); the stacked QOI
        values (or samples)."""
        self.state, out = sample_chain(self.sampler, self.state, self.b, n, extract=self._qoi, burnin=burnin)
        return out

    def sample_mean_and_var(self, n: int, burnin: int = 0):
        """(mean, var) fields over n recorded steps."""
        self.state, mean, var = sample_moments(self.sampler, self.state, self.b, n, burnin=burnin)
        return mean, var

    def sample_chains(self, n: int, n_chains: int, burnin: int = 0):
        """(n_chains, n, ...) QOI traces of ``n_chains`` independent chains
        (see :func:`_sample_chains`)."""
        return _sample_chains(self, None, n, n_chains, burnin)


class MaternMeshSampler:
    """Matérn sampling on an unstructured mesh through MGMC.

    ``observations`` is a dict(sigma2=..., coords=..., radii=...,
    values=...) of ball-average observations; ``hierarchy`` is
    ``"algebraic"`` or ``"geometric"`` (P1 only, needs ``refinements`` > 0);
    ``order`` is the FE order (1 = P1, 2 = CG2).  The remaining keywords
    go to ``MGMCSampler.create`` (algebraic) or set the geometric cycle
    (``omega``, ``sweep``, ``n_pre``, ``n_post``, ``n_coarse``, ``gamma``,
    ``n_levels``).  The operator and the chain live on ``device`` (the
    card when None)."""

    def __init__(self, mesh_file=None, points=None, cells=None, kappa: float = 1.0,
                 refinements: int = 0, dtype=torch.float64, seed: int = 0, observations=None,
                 hierarchy: str = "algebraic", order: int = 1, device=None, **mgmc_kwargs):
        from parmgmc_tpu_torch.models import mesh as _mesh
        from parmgmc_tpu_torch.operators.graph import from_csr
        from parmgmc_tpu_torch.operators.lrc import LRCOperator

        if hierarchy not in ("algebraic", "geometric"):
            raise ValueError(f"unknown hierarchy {hierarchy!r} (algebraic or geometric)")
        dev = resolve_device(device)
        if mesh_file is not None:
            points, cells = _mesh.read_gmsh(_mesh.mesh_path(mesh_file))
        Ps = []
        for _ in range(refinements):
            if hierarchy == "geometric":
                points, cells, P = _mesh.refine(points, cells, True)
                Ps.append(P)
            else:
                points, cells = _mesh.refine(points, cells)
        self.points, self.cells = points, cells
        if order == 2:
            if hierarchy == "geometric":
                raise ValueError("the geometric hierarchy is P1 only; use algebraic for CG2")
            A, self.dof_points = _mesh.matern_precision_mesh_p2(points, cells, kappa)
        else:
            A = _mesh.matern_precision_mesh(points, cells, kappa)
            self.dof_points = points
        self.op = from_csr(A, dtype=dtype, device=dev)
        self.n = self.op.n

        op = self.op
        self.b = torch.zeros((self.n,), dtype=dtype, device=dev)
        if observations is not None:
            B, sigma_inv, f = _mesh.mesh_observation_mats(
                points, cells, observations["sigma2"], observations["coords"],
                observations["radii"], observations.get("values"), order=order,
            )
            B_int = torch.as_tensor(B, device=dev).to(dtype)[self.op.perm]
            op = LRCOperator(base=self.op, B=B_int, sigma_inv=torch.as_tensor(sigma_inv, device=dev).to(dtype))
            if f is not None:
                self.b = torch.as_tensor(f, device=dev).to(dtype)[self.op.perm]
        self.operator = op

        if hierarchy == "geometric":
            if not Ps:
                raise ValueError("hierarchy='geometric' needs refinements > 0")
            from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler

            n_levels = mgmc_kwargs.pop("n_levels", None)
            if n_levels is not None:
                Ps = Ps[-(n_levels - 1):] if n_levels > 1 else []
            mgmc_kwargs.pop("coarsest_size", None)
            ops, transfers = _mesh.geometric_mgmc_hierarchy(op, Ps, dtype=dtype)
            self.sampler = MGMCSampler.from_levels(
                ops, transfers, CholeskySampler.create(ops[-1]),
                omega=mgmc_kwargs.pop("omega", 1.0), sweep=mgmc_kwargs.pop("sweep", "forward"),
                n_pre=mgmc_kwargs.pop("n_pre", 1), n_post=mgmc_kwargs.pop("n_post", 1),
                n_coarse=mgmc_kwargs.pop("n_coarse", 1), gamma=mgmc_kwargs.pop("gamma", 1),
            )
            if mgmc_kwargs:
                raise TypeError(f"unused options for the geometric hierarchy: {sorted(mgmc_kwargs)}")
        else:
            self.sampler = MGMCSampler.create(op, **mgmc_kwargs)
        self.state = init_chain(self.sampler, int(seed))
        self._qoi: Optional[Callable] = None
        self._chain_states = {}

    def set_qoi(self, fn: Callable):
        """The QOI applied to each sample in ORIGINAL node order."""
        self._qoi = fn

    def sample(self, n: int = 1, burnin: int = 0):
        """Advance the chain n steps (after ``burnin``); the stacked QOI
        values (or samples, in original order)."""
        user, iperm = self._qoi or (lambda x: x), self.op.iperm
        self.state, out = sample_chain(self.sampler, self.state, self.b, n,
                                       extract=lambda x: user(x[iperm]), burnin=burnin)
        return out

    def sample_mean_and_var(self, n: int, burnin: int = 0):
        """(mean, var) fields over n recorded steps, in original order."""
        self.state, mean, var = sample_moments(self.sampler, self.state, self.b, n, burnin=burnin)
        return mean[self.op.iperm], var[self.op.iperm]

    def sample_chains(self, n: int, n_chains: int, burnin: int = 0):
        """(n_chains, n, ...) QOI traces (original order) of ``n_chains``
        independent chains (see :func:`_sample_chains`)."""
        return _sample_chains(self, self.op.iperm, n, n_chains, burnin)


def _sample_chains(ms, iperm, n, n_chains, burnin):
    """The many-chains driver of both façades: (n_chains, n, ...) QOI
    traces.  The chains' states are made once per ``n_chains`` (keys from
    the main chain's key folded with ``n_chains``) and kept on the façade,
    so calls continue them.

    Graph samplers (:func:`batched_chains_supported`) run chain-major: one
    state x of shape (n, C), one keyed step for every chain, the user's
    QOI mapped over the chains after one permutation.  Every other sampler
    runs the chains one at a time through :func:`multi_chain`, each with
    its own key (JAX ``split(fold_in(key, n_chains), n_chains)``)."""
    user = ms._qoi or (lambda x: x)
    key = keys.fold_in(ms.state.key, n_chains)
    states = ms._chain_states
    if batched_chains_supported(ms.sampler):
        perm = (lambda x: x) if iperm is None else (lambda x: x[iperm])
        extract = lambda x: torch.func.vmap(user, in_dims=-1)(perm(x))
        if n_chains not in states:
            states[n_chains] = init_chain(ms.sampler, key, batch=(n_chains,))
        states[n_chains], out = sample_chain(ms.sampler, states[n_chains], ms.b, n, extract=extract, burnin=burnin)
        return out.transpose(0, 1)  # (n_steps, C, ...) -> (C, n_steps, ...)
    per = user if iperm is None else (lambda x: user(x[iperm]))
    if n_chains not in states:
        x0 = torch.zeros((n_chains, *ms.sampler.grid_shape), dtype=ms.sampler.dtype, device=ms.sampler.device)
        states[n_chains] = ChainState(x=x0, key=keys.split(key, n_chains))
    run = multi_chain(lambda st: sample_chain(ms.sampler, st, ms.b, n, extract=per, burnin=burnin), n_chains)
    states[n_chains], out = run(states[n_chains])
    return out


def batched_chains_supported(sampler) -> bool:
    """Does ``sampler`` take the chain-major layout (x of shape (n, C), one
    keyed step advancing C chains)?  Gibbs on a graph base (possibly LRC),
    and MGMC over such levels with Gibbs smoothers and a dense Cholesky
    coarse level: the JAX ``_batched_chains_supported``."""
    from parmgmc_tpu_torch.operators.graph import GraphOperator
    from parmgmc_tpu_torch.operators.lrc import LRCOperator
    from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
    from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler

    def graph_gibbs(s):
        return isinstance(s, GibbsSampler) and isinstance(s.base, GraphOperator)

    if isinstance(sampler, GibbsSampler):
        return graph_gibbs(sampler)
    if isinstance(sampler, MGMCSampler):
        op0 = sampler.fine_op
        base0 = op0.base if isinstance(op0, LRCOperator) else op0
        return (isinstance(base0, GraphOperator) and all(graph_gibbs(s) for s in sampler.smoothers)
                and isinstance(sampler.coarse, CholeskySampler))
    return False
