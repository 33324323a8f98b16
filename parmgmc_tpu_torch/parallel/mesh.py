"""A mesh of shard slots, block layouts and the collectives between them
(port of the mesh part of ``parmgmc_tpu.parallel.mesh``).

The JAX package is single-controller: ``shard_map`` runs every shard from
one process, and ``jax.lax`` moves the halos.  Here a :class:`Mesh` is a
named grid of slots over a list of ``torch.device`` s, a sharded grid
field is a list of per-slot blocks along grid axis 0
(:func:`shard_array`, :func:`unshard`), and the three collectives the
sharded samplers need are plain copies between the slots' devices:

* :func:`exchange_planes` -- the ``ppermute`` pair of JAX's
  ``parallel.fused._exchange_planes``: each block receives ``h`` planes
  from each axis-0 neighbour, zeros at the chain ends (the global
  zero-padding boundary);
* :func:`psum` -- the sum of one tensor a slot, added in slot order so
  that every slot holds the same bits;
* :func:`all_gather` -- the blocks concatenated, on every slot.

Copies between distinct cards are ``non_blocking`` and add no
synchronisation; torch orders them on the devices' current streams.
Slots that share a card run in turn on its stream, and a collective
computes once a device, not once a slot.

The level rule (:func:`level_specs`) is JAX's: a grid dimension is
sharded over its mesh axis while it divides evenly with at least
``min_local`` points a shard, coarser levels are replicated.
:func:`shard_sampler` runs any structured Gibbs or MGMC sampler on the
blocks that rule gives (:mod:`.spmd`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "Mesh",
    "make_mesh",
    "level_specs",
    "shard_array",
    "unshard",
    "exchange_planes",
    "psum",
    "all_gather",
    "canonical",
    "shard_sampler",
]


def canonical(device) -> torch.device:
    """``device`` as tensors report it: a CUDA device with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A named grid of shard slots over devices (``jax.sharding.Mesh``).

    ``devices`` is a numpy object array of ``torch.device`` of the mesh's
    shape; two slots may hold the same device."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def slots(self, axis_name=None) -> list:
        """The devices of the slots along ``axis_name`` (the first axis by
        default), the other axes at index 0: the shards of a field sharded
        over that axis and replicated over the others."""
        ax = self.axis_names.index(axis_name if axis_name is not None else self.axis_names[0])
        idx = [0] * self.devices.ndim
        idx[ax] = slice(None)
        return list(self.devices[tuple(idx)])


def make_mesh(mesh_shape, axis_names=None, devices=None) -> Mesh:
    """A mesh of ``prod(mesh_shape)`` slots, e.g. ``make_mesh((2, 4))``.

    Without ``devices`` each slot gets its own card (``cuda:0``,
    ``cuda:1``, ...) and a machine with too few raises: the mesh never
    folds shards onto fewer cards unasked.  ``devices`` lists the slots'
    devices in order (``["cuda:0"] * 4``: four slots on one card;
    ``["cpu"] * 8`` on the host)."""
    mesh_shape = tuple(int(s) for s in mesh_shape)
    n = math.prod(mesh_shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(
                f"a mesh of {n} slots needs {n} distinct CUDA devices, found {have}; pass "
                f"devices=[...] to put several slots on one device")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [canonical(d) for d in devices]
        if len(devices) < n:
            raise ValueError(f"a mesh of {n} slots got {len(devices)} devices")
    if axis_names is None:
        axis_names = ("x", "y", "z")[: len(mesh_shape)]
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(mesh_shape), axis_names)


def _spec_for_shape(shape, grid_specs) -> tuple:
    """The axes of a leaf: the spec of the first grid shape its leading
    dims match, padded with None; () (replicated) when none matches."""
    for gshape, axes in grid_specs:
        d = len(gshape)
        if len(shape) >= d and tuple(shape[:d]) == gshape:
            return (*axes, *([None] * (len(shape) - d)))
    return ()


def level_specs(grid_shapes, mesh: Mesh, min_local: int = 4, grid_axes=None) -> list:
    """(grid_shape, axes) pairs: which grid shapes are sharded and how.

    A grid dim i is sharded over mesh axis ``grid_axes[i]`` (default: the
    mesh axis names in order) while grid_shape[i] / mesh_size >= min_local
    and divisible; coarser levels fall back to replication (no pair)."""
    specs = []
    names = grid_axes if grid_axes is not None else mesh.axis_names
    for gshape in grid_shapes:
        axes = []
        for i, s in enumerate(gshape):
            if i < len(names) and names[i] is not None:
                m = mesh.shape[names[i]]
                axes.append(names[i] if s % m == 0 and s // m >= min_local else None)
            else:
                axes.append(None)
        if all(a is None for a in axes):
            continue
        specs.append((tuple(gshape), tuple(axes)))
    return specs


def shard_array(x: torch.Tensor, mesh: Mesh, axis: int = 0, axis_name=None) -> list:
    """The blocks of ``x`` along grid axis ``axis`` over the slots of
    ``axis_name`` (the first mesh axis by default), each a copy on its
    slot's device."""
    slots = mesh.slots(axis_name)
    n = x.shape[axis]
    if n % len(slots):
        raise ValueError(f"axis {axis} of extent {n} does not split over {len(slots)} slots")
    m = n // len(slots)
    return [x.narrow(axis, i * m, m).to(dev, copy=True).contiguous()
            for i, dev in enumerate(slots)]


def unshard(blocks, axis: int = 0, device=None) -> torch.Tensor:
    """The field of the blocks (the inverse of :func:`shard_array`), on
    ``device`` (the first block's by default)."""
    device = blocks[0].device if device is None else device
    return torch.cat([b.to(device) for b in blocks], dim=axis)


def exchange_planes(blocks, h: int) -> list:
    """[(lo, hi)] a block: the last ``h`` planes of axis 0 of the block
    before it and the first ``h`` of the block after it, on the block's
    device; zeros at the chain ends."""
    out = []
    for i, v in enumerate(blocks):
        zeros = v.new_zeros((h, *v.shape[1:]))
        lo = blocks[i - 1][-h:].to(v.device, non_blocking=True) if i > 0 else zeros
        hi = blocks[i + 1][:h].to(v.device, non_blocking=True) if i + 1 < len(blocks) else zeros
        out.append((lo, hi))
    return out


def _per_device(parts, fn) -> list:
    """fn(parts moved to d) once for each distinct device d of parts, in
    slot order; the result of each part's device, a part."""
    done = {}
    for p in parts:
        if p.device not in done:
            done[p.device] = fn([q.to(p.device, non_blocking=True) for q in parts])
    return [done[p.device] for p in parts]


def psum(parts) -> list:
    """The sum of one tensor a slot, on every slot: added in slot order
    on each device, so every slot holds the same bits."""

    def total(ps):
        s = ps[0]
        for q in ps[1:]:
            s = s + q
        return s

    return _per_device(parts, total)


def all_gather(parts, dim: int = 0) -> list:
    """The blocks concatenated along ``dim``, on every slot."""
    return _per_device(parts, lambda ps: torch.cat(ps, dim=dim))


def _collect_grid_shapes(sampler) -> list:
    """The grid shape of every level of ``sampler`` (its own for a
    one-level sampler)."""
    ops = getattr(sampler, "ops", None)
    if ops is not None:
        return [tuple(o.grid_shape) for o in ops]
    return [tuple(sampler.grid_shape)]


def _force_lax_impl(sampler):
    """The sampler with every kernel route turned to plain torch
    (:func:`~parmgmc_tpu_torch.samplers.registry.lax_variant`): the
    kernels take whole grids, the sharded step runs the plain sweeps on
    halo-extended blocks."""
    from parmgmc_tpu_torch.samplers.registry import lax_variant

    return lax_variant(sampler)


def _refuse(sampler):
    """Raise for what the sharded step cannot split: patch samplers and
    low-rank-corrected (posterior) operators."""
    from parmgmc_tpu_torch.operators.lrc import LRCOperator
    from parmgmc_tpu_torch.samplers.patch_gibbs import GraphPatchGibbsSampler, PatchGibbsSampler

    parts = [sampler, *getattr(sampler, "smoothers", ())]
    if any(isinstance(p, (PatchGibbsSampler, GraphPatchGibbsSampler)) for p in parts):
        raise ValueError("shard_sampler does not split patch samplers (their sweeps are whole-grid)")
    ops = getattr(sampler, "ops", None) or [getattr(sampler, "lrc", None) or getattr(sampler, "base", None)]
    if any(isinstance(o, LRCOperator) for o in ops) or any(getattr(p, "is_lrc", False) for p in parts):
        raise ValueError("shard_sampler does not split LRC (posterior) operators: shard a structured "
                         "posterior with parallel.fused.make_sharded_mgmc_step and an unstructured one "
                         "with parallel.graph_sharded.make_sharded_graph_mgmc_step")


def shard_sampler(sampler, mesh: Mesh, min_local: int = 4, grid_axes=None):
    """(sharded_sampler, state_layout): ``sampler`` run on blocks of the
    mesh's slots (the JAX ``shard_sampler``).

    The sampler takes its plain routes (``lax_variant``); grid dim i of a
    level is split over mesh axis ``grid_axes[i]`` (default: the mesh
    axes in order, but ``"chain"``) as :func:`level_specs` rules, coarser
    levels are replicated, and a mesh axis named ``"chain"`` splits the
    trailing chain axis of x.  The sharded sampler has the wrapped one's
    ``step_with_noise(xs, bs, noises)``, ``step(key, xs, bs)`` and
    ``noise_shapes()`` on lists of slot blocks (``state_layout.shard``,
    ``state_layout.unshard``), and equals its unsharded plain steps bit
    for bit (see :mod:`.spmd`).

    Structured Gibbs and MGMC samplers (stencil operators, geometric or
    aggregate transfers, a dense Cholesky coarsest level) are split on
    their grids; a sampler of a graph operator splits its chains only
    (its rows are :mod:`.graph_sharded`'s).  Patch samplers and LRC
    operators raise."""
    from parmgmc_tpu_torch.operators.graph import GraphOperator
    from parmgmc_tpu_torch.parallel import spmd
    from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    _refuse(sampler)
    if not isinstance(sampler, (GibbsSampler, MGMCSampler)):
        raise ValueError(f"shard_sampler takes Gibbs and MGMC samplers, not {type(sampler).__name__}")
    sampler = _force_lax_impl(sampler)
    names = grid_axes
    if names is None:
        names = tuple(a for a in mesh.axis_names if a != spmd.CHAIN_AXIS)
    used = [a for a in names if a is not None]
    if spmd.CHAIN_AXIS in used or len(set(used)) != len(used) or not set(used) <= set(mesh.axis_names):
        raise ValueError(f"grid_axes {tuple(names)} must name distinct mesh axes {mesh.axis_names} "
                         f"other than {spmd.CHAIN_AXIS!r}")
    shapes = _collect_grid_shapes(sampler)
    ops = getattr(sampler, "ops", None) or [sampler.base]
    graph = any(isinstance(getattr(o, "base", o), GraphOperator) for o in ops)
    specs = level_specs(shapes, mesh, min_local, names)
    if graph and specs:
        raise ValueError("a graph (unstructured-mesh) sampler splits its chains only under shard_sampler "
                         "(a 'chain' mesh axis and grid_axes=(None,)); row partitioning is "
                         "parallel.graph_sharded")
    sharded = spmd.build(sampler, mesh, specs, shapes)
    return sharded, sharded.layout
