"""Sampler composition by config tree (port of ``parmgmc_tpu.samplers.registry``).

Every node of a nested dict names a sampler type and its options; inner
samplers are sub-dicts, as the reference's options-database prefixes
nest.  Example::

    build_sampler(op, {
        "type": "mgmc",
        "n_levels": 3,
        "smoother": {"type": "gibbs", "omega": 1.0, "sweep": "symmetric"},
        "n_pre": 2, "n_post": 2,
        "coarse": {"type": "cholesky"},
    })

Types registered: ``gibbs`` (``"ordering": "natural"`` for
:class:`~parmgmc_tpu_torch.samplers.sor.NaturalGibbsSampler`),
``cholesky`` (``"mode"``: ``"dense"``, ``"sparse"`` for the host's
:class:`~parmgmc_tpu_torch.samplers.cholesky.SparseCholeskySampler`,
``"auto"`` for :func:`~parmgmc_tpu_torch.samplers.cholesky.exact_sampler`
with ``"dense_threshold"``), ``mgmc``, ``woodbury`` and ``patch_gibbs``
(:class:`~parmgmc_tpu_torch.samplers.patch_gibbs.GraphPatchGibbsSampler`
on a graph operator).  Each
builder consumes its options from the node and builds its samplers with
the port's own ``create`` (on the operator's device), so a tree builds
the same sampler the direct calls do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from parmgmc_tpu_torch.operators.graph import GraphOperator
from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.operators.stencil import StencilOperator
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler, SparseCholeskySampler, exact_sampler
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler, build_hierarchy
from parmgmc_tpu_torch.samplers.patch_gibbs import GraphPatchGibbsSampler, PatchGibbsSampler
from parmgmc_tpu_torch.samplers.sor import NaturalGibbsSampler
from parmgmc_tpu_torch.samplers.woodbury import WoodburySampler

__all__ = ["build_sampler", "lax_variant", "register_sampler"]


def lax_variant(sampler):
    """The same sampler with every kernel route turned to plain torch
    (``impl="torch"``), recursively through MGMC smoothers and Woodbury's
    inner sampler (the JAX ``lax_variant``).

    The samplers, their update order and their math are unchanged; the
    keyed steps draw their noise from ``keys.generator``, as the
    explicit-noise route does, and launch no kernel.  An MGMC sampler also
    drops the rank-k matrices of its level-0 chain kernel and the packs of
    its residual kernel, and its linear transfers add the prolonged
    correction in plain torch.  Take it for
    trailing chain dims on a structured sampler (the kernels take one
    chain), or to run a configuration without a GPU kernel."""

    def fix(obj):
        if getattr(obj, "impl", "torch") != "torch":
            obj = dataclasses.replace(obj, impl="torch")
        if hasattr(obj, "smoothers"):
            obj = dataclasses.replace(obj, smoothers=tuple(fix(s) for s in obj.smoothers),
                                      transfers=tuple(fix(t) for t in obj.transfers), lrc_aux=None,
                                      residual_packs=None)
        if hasattr(obj, "sampler"):  # Woodbury's inner sampler
            obj = dataclasses.replace(obj, sampler=fix(obj.sampler))
        return obj

    return fix(sampler)

_REGISTRY: Dict[str, Callable] = {}


def register_sampler(name: str):
    """Decorator: register ``fn(op, cfg) -> sampler`` as type ``name``."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def build_sampler(op, config: dict):
    """The sampler the config tree ``config`` names, on ``op``."""
    cfg = dict(config)
    typ = cfg.pop("type")
    if typ not in _REGISTRY:
        raise ValueError(f"unknown sampler type {typ!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[typ](op, cfg)


@register_sampler("gibbs")
def _build_gibbs(op, cfg):
    omega = cfg.pop("omega", 1.0)
    sweep = cfg.pop("sweep", "forward")
    if cfg.pop("ordering", "multicolor") == "natural":
        return NaturalGibbsSampler.create(op, omega=omega, sweep=sweep)
    return GibbsSampler.create(op, omega=omega, sweep=sweep)


@register_sampler("cholesky")
def _build_cholesky(op, cfg):
    mode = cfg.pop("mode", "dense")
    if mode == "sparse":
        return SparseCholeskySampler.create(op)
    if mode == "auto":
        return exact_sampler(op, cfg.pop("dense_threshold", 20_000))
    return CholeskySampler.create(op)


@register_sampler("patch_gibbs")
def _build_patch_gibbs(op, cfg):
    if isinstance(op, GraphOperator):
        return GraphPatchGibbsSampler.create(op)
    if not isinstance(op, (StencilOperator, LRCOperator)):
        raise TypeError(f"patch Gibbs needs a stencil or graph operator, got {type(op).__name__}")
    return PatchGibbsSampler.create(op)


@register_sampler("mgmc")
def _build_mgmc(op, cfg):
    smoother_cfg = cfg.pop("smoother", {"type": "gibbs"})
    coarse_cfg = cfg.pop("coarse", {"type": "cholesky"})
    ops, transfers = build_hierarchy(
        op,
        n_levels=cfg.pop("n_levels", None),
        coarsest_size=cfg.pop("coarsest_size", 128),
        coarsening=cfg.pop("coarsening", "linear"),
    )
    return MGMCSampler.from_levels(
        ops, transfers, build_sampler(ops[-1], dict(coarse_cfg)),
        smoothers=tuple(build_sampler(o, dict(smoother_cfg)) for o in ops[:-1]),
        n_pre=cfg.pop("n_pre", 1), n_post=cfg.pop("n_post", 1),
        n_coarse=cfg.pop("n_coarse", 1), gamma=cfg.pop("gamma", 1),
    )


@register_sampler("woodbury")
def _build_woodbury(op, cfg):
    if not isinstance(op, LRCOperator):
        raise TypeError("woodbury needs an LRCOperator")
    inner = build_sampler(op.base, dict(cfg.pop("sampler", {"type": "cholesky"})))
    return WoodburySampler.create(op, inner, solver=cfg.pop("solver", "auto"))
