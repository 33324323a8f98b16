"""A structured sampler's step on blocks of mesh slots, with the halo
exchanges written out (the machinery of :func:`.mesh.shard_sampler`).

The JAX package places each leaf of a sampler on a device mesh and lets
GSPMD partition the step: the stencil shifts become halo
``collective-permute`` s and the coarse levels below ``min_local`` are
replicated.  Torch has no GSPMD, so this module does by hand what XLA
inserts there, from one process:

* a **level** (:class:`Level`) is a grid shape with, for each grid axis,
  the mesh axis that splits it (or None); a field of the level is a dict of
  **pieces**, one for each distinct (device, block, chain block), so slots
  that hold the same block on one device compute it once;
* a **halo** of the stencil's reach comes from the neighbouring blocks on
  each split axis -- axis 0 first, then axis 1 of the axis-0-extended
  pieces, so the corners a 9- or 27-point stencil reads come along --
  with zeros past the global ends (the operators' zero padding);
* ``apply`` and every colour of a sweep run on the extended piece and
  keep its block; a sweep refreshes the halo before each colour (two
  colours for a star stencil, 2^d sublattices for a dense one), and the
  colour of a point is that of its GLOBAL index;
* the transfers are block-local on blocks of even extents:
  ``AggregateTransfer`` needs no halo, ``GeometricTransfer`` one point of
  the fine field below the block to restrict and one of the coarse field
  above it to prolong;
* levels that ``level_specs`` does not split (below ``min_local``) are
  replicated: the restriction's blocks are gathered, and the rest of the
  cycle, the dense Cholesky sample included, runs once a distinct device
  (and chain block); each slot slices its block on the way up.

Every point is computed by the same operations, in the same order, as in
the unsharded plain step, so the sharded ``step_with_noise`` equals the
unsharded one bit for bit, and so does the keyed ``step``: it draws each
leaf of the noise over the GLOBAL shape from ``keys.generator``, in the
order the unsharded plain keyed step draws it, once a distinct device,
and each piece slices its block (this draw does not weak-scale).

Chains: x may carry one trailing chain axis (``(*grid, C)``, the port's
chain-major layout); a mesh axis named ``"chain"`` splits it over its
slots.  Inside, pieces hold the chains leading, ``(C, *block)``, so the
stencil arithmetic runs on every chain at once; the coarse Cholesky
sample takes them one at a time, as the unsharded step does.  A sampler
whose finest level no grid axis splits (an unstructured-mesh sampler, or
a mesh of chains only) runs its own ``step_with_noise`` on each piece's
chains.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.kernels._twin import noise_factor
from parmgmc_tpu_torch.operators.stencil import StencilOperator, _prolong_1d, _restrict_1d, lattice
from parmgmc_tpu_torch.operators.transfer import (
    AggregateTransfer,
    GeometricTransfer,
    _agg_down_1d,
    _agg_up_1d,
)
from parmgmc_tpu_torch.parallel.mesh import Mesh, canonical
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler, _draw, with_batch
from parmgmc_tpu_torch.samplers.sor import num_colors, sublattice_update

__all__ = ["Level", "StateLayout", "ShardedSampler", "keyed_noises"]

CHAIN_AXIS = "chain"


class Level:
    """A grid split into blocks over mesh axes, and its pieces.

    ``axes[i]`` names the mesh axis that splits grid axis i (None: whole).
    A piece key is (device, block coordinates, chain block): slots with
    the same key hold the same tensor."""

    def __init__(self, mesh: Mesh, grid_shape, axes, chain_axis=None):
        self.mesh = mesh
        self.grid_shape = tuple(int(n) for n in grid_shape)
        self.axes = tuple(axes)
        self.nblk = tuple(mesh.shape[a] if a else 1 for a in self.axes)
        self.local = tuple(n // m for n, m in zip(self.grid_shape, self.nblk))
        self.split = tuple(i for i, a in enumerate(self.axes) if a)
        self.chain_axis = chain_axis
        names = mesh.axis_names
        self.slot_keys = []
        for idx in np.ndindex(mesh.devices.shape):
            coords = tuple(idx[names.index(a)] if a else 0 for a in self.axes)
            cb = idx[names.index(chain_axis)] if chain_axis else 0
            self.slot_keys.append((canonical(mesh.devices[idx]), coords, cb))
        self.keys = list(dict.fromkeys(self.slot_keys))
        self.where = {}  # (coords, chain block) -> the first piece that holds it
        for k in self.keys:
            self.where.setdefault(k[1:], k)

    @property
    def n_chain_blocks(self) -> int:
        return self.mesh.shape[self.chain_axis] if self.chain_axis else 1

    def with_grid(self, grid_shape) -> "Level":
        """The same split of another grid (a transfer's coarse side)."""
        return Level(self.mesh, grid_shape, self.axes, self.chain_axis)

    def start(self, coords) -> tuple:
        return tuple(c * n for c, n in zip(coords, self.local))

    def block(self, t, coords, lead: int = 0):
        """The block at ``coords`` of a grid tensor whose grid dims start
        at dim ``lead`` (a view)."""
        for ax in self.split:
            t = t.narrow(lead + ax, coords[ax] * self.local[ax], self.local[ax])
        return t

    def find(self, field, device, coords, cb):
        """The piece of block ``coords`` (chain block ``cb``), on ``device``
        when a piece there holds it."""
        t = field.get((device, coords, cb))
        return field[self.where[(coords, cb)]] if t is None else t

    def last(self, coords, ax) -> bool:
        return coords[ax] == self.nblk[ax] - 1


def extend(lv: Level, field: dict, h: int, lead: int, lo: bool = True, hi: bool = True) -> dict:
    """Each piece with ``h`` cells of its neighbours on every split axis
    (below with ``lo``, above with ``hi``), axis by axis, so corners come
    along; zeros past the global ends."""
    for ax in lv.split:
        dim = lead + ax
        out = {}
        for (dev, coords, cb), v in field.items():
            parts = []
            for side, step in ((lo, -1), (hi, 1)):
                if not side:
                    continue
                j = coords[ax] + step
                if 0 <= j < lv.nblk[ax]:
                    nb = lv.find(field, dev, coords[:ax] + (j,) + coords[ax + 1:], cb)
                    nb = nb.narrow(dim, nb.shape[dim] - h if step < 0 else 0, h).to(dev, non_blocking=True)
                else:
                    shape = list(v.shape)
                    shape[dim] = h
                    nb = v.new_zeros(shape)
                parts.append(nb)
            parts.insert(1 if lo else 0, v)
            out[(dev, coords, cb)] = torch.cat(parts, dim=dim)
        field = out
    return field


def assemble(lv: Level, field: dict, device, cb, lead: int):
    """The whole grid of chain block ``cb`` on ``device``, its blocks
    concatenated."""

    def rec(i, coords):
        if i == len(lv.split):
            return lv.find(field, device, coords, cb).to(device, non_blocking=True)
        ax = lv.split[i]
        return torch.cat([rec(i + 1, coords[:ax] + (j,) + coords[ax + 1:]) for j in range(lv.nblk[ax])],
                         dim=lead + ax)

    return rec(0, (0,) * len(lv.grid_shape))


def relayout(src: Level, field: dict, dst: Level, lead: int) -> dict:
    """A field of ``src`` in the blocks of ``dst`` (same grid): gathered
    on each device, then sliced; the field itself when the splits agree."""
    if src.axes == dst.axes:
        return field
    whole = {}
    out = {}
    for dev, coords, cb in dst.keys:
        if (dev, cb) not in whole:
            whole[(dev, cb)] = assemble(src, field, dev, cb, lead)
        out[(dev, coords, cb)] = dst.block(whole[(dev, cb)], coords, lead)
    return out


def _restrict_block(f, dim: int, last: bool):
    """Full weighting along ``dim`` of a block of even extent preceded by
    one point of the block below it: the global formula's terms, in its
    order, with the boundary fix on the last block."""
    f = torch.movedim(f, dim, -1)
    ev, od = f[..., 1::2], f[..., 2::2]
    y = ev + 0.5 * od + 0.5 * torch.cat([f[..., :1], od[..., :-1]], dim=-1)
    if last:
        y = torch.cat([y[..., :-1], y[..., -1:] + 0.5 * od[..., -1:]], dim=-1)
    return torch.movedim(y, -1, dim)


def _prolong_block(c, dim: int, last: bool):
    """Linear interpolation along ``dim`` of a coarse block followed by one
    point of the block above it (ignored on the last block, whose last
    fine node takes the full weight of its coarse node)."""
    c = torch.movedim(c, dim, -1)
    own = c[..., :-1]
    if last:
        tail = 0.5 * own[..., -1:] + 0.5 * own[..., -1:]
        od = torch.cat([0.5 * (own[..., :-1] + own[..., 1:]), tail], dim=-1)
    else:
        od = 0.5 * (c[..., :-1] + c[..., 1:])
    z = torch.stack([own, od], dim=-1).reshape(*own.shape[:-1], 2 * own.shape[-1])
    return torch.movedim(z, -1, dim)


class _LevelOp:
    """A level's stencil and Gibbs smoother on each piece: the coefficient
    and diagonal blocks, omega / diag, the noise scale and the colour
    masks, sliced from the global fields (so every value is the global
    one)."""

    def __init__(self, lv: Level, op: StencilOperator, smoother=None):
        self.lv, self.op = lv, op
        self.r = op.radius
        self.star = op.is_star()
        self.ncolors = num_colors(op)
        self.omega = smoother.omega if smoother is not None else 1.0
        self.sweep = smoother.sweep if smoother is not None else "forward"
        diag = op.diag
        coeffs = op.coeffs
        inv = self.omega / diag
        ns = None
        if smoother is not None:
            ns = smoother.noise_scale
            if ns is None:
                ns = noise_factor(self.omega, op.dtype) * torch.sqrt(diag)
        self.consts = {}
        for dev, coords, _ in lv.keys:
            if (dev, coords) in self.consts:
                continue
            blk = lambda t: lv.block(t, coords).to(dev).contiguous()  # noqa: E731
            c = dict(diag=blk(diag), inv=blk(inv), ns=None if ns is None else blk(ns),
                     coeffs=[t.to(dev) if t.ndim == 0 else blk(t) for t in coeffs])
            if self.star:
                base = self.r + 1
                code = 0
                for ax, (s, n) in enumerate(zip(lv.start(coords), lv.local)):
                    view = [1] * len(lv.local)
                    view[ax] = n
                    code = code + (torch.arange(n, device=dev) + s).reshape(view)
                c["masks"] = [(code % base).expand(lv.local) == k for k in range(self.ncolors)]
            self.consts[(dev, coords)] = c
        # pads of the axes no block splits (a split axis has its halo)
        self.pad = []
        for ax in reversed(range(len(lv.local))):
            p = 0 if ax in lv.split else self.r
            self.pad += [p, p]

    def _padded(self, xe):
        return F.pad(xe, self.pad)

    def offdiag(self, key, xe):
        """(A - D) x on the block of a piece extended by the stencil's
        reach: the global ``offdiag_apply``'s terms, in its order."""
        c = self.consts[key[:2]]
        xp = self._padded(xe)
        shape = self.lv.local
        lead = xe.dim() - len(shape)
        y = xe.new_zeros(xe.shape[:lead] + shape)
        for off, coef in zip(self.op.offsets, c["coeffs"]):
            y = y + coef * lattice(xp, [self.r + o for o in off], shape)
        return y

    def apply(self, x: dict) -> dict:
        xe = extend(self.lv, x, self.r, self._lead(x))
        return {k: self.consts[k[:2]]["diag"] * v + self.offdiag(k, xe[k]) for k, v in x.items()}

    def _lead(self, field):
        return next(iter(field.values())).dim() - len(self.lv.local)

    def sweep_colours(self, b: dict, x: dict, direction: str) -> dict:
        """One multicolour SOR sweep, the halo refreshed before each colour."""
        if direction == "symmetric":
            x = self.sweep_colours(b, x, "forward")
            return self.sweep_colours(b, x, "backward")
        order = range(self.ncolors) if direction == "forward" else reversed(range(self.ncolors))
        lead = self._lead(x)
        om, r, shape = self.omega, self.r, self.lv.local
        crop = (Ellipsis, *(slice(r, r + n) for n in shape))
        for col in order:
            xe = extend(self.lv, x, r, lead)
            out = {}
            for k, v in x.items():
                c = self.consts[k[:2]]
                if self.star:
                    xc = (1.0 - om) * v + c["inv"] * (b[k] - self.offdiag(k, xe[k]))
                    out[k] = torch.where(c["masks"][col], xc, v)
                else:
                    xp = self._padded(xe[k])
                    sublattice_update(xp, b[k], c["inv"], self.op.offsets, c["coeffs"], shape, r, om, col,
                                      origin=self.lv.start(k[1]))
                    out[k] = xp[crop].contiguous()
            x = out
        return x


def _cycle_noises(smp, l: int, key: int, batch: tuple, draw):
    """The noise tree of one keyed cycle from level l, drawn in the order
    ``MGMCSampler._cycle_general`` draws it (each smoother step and each
    coarse sample splits the key as its own keyed step does)."""
    if l == smp.n_levels - 1:
        out = []
        for _ in range(smp.n_coarse):
            key, sub = keys.split(key)
            out.append(draw(sub, with_batch(smp.coarse.noise_shapes(), batch)))
        return out
    shapes = with_batch(smp.smoothers[l].noise_shapes(), batch)
    pre, subs, post = [], [], []
    for _ in range(smp.n_pre):
        key, sub = keys.split(key)
        pre.append(draw(sub, shapes))
    for _ in range(smp.gamma):
        key, sub = keys.split(key)
        subs.append(_cycle_noises(smp, l + 1, sub, batch, draw))
    for _ in range(smp.n_post):
        key, sub = keys.split(key)
        post.append(draw(sub, shapes))
    return {"pre": pre, "sub": subs, "post": post}


def keyed_noises(smp, key: int, batch: tuple, dtype, device):
    """(key', noises): the noise tree the plain keyed ``step`` of ``smp``
    (a Gibbs or MGMC sampler with every route plain) draws under ``key``
    for x with trailing chain dims ``batch``, drawn on ``device``; then
    ``smp.step(key, x, b) == (key', smp.step_with_noise(x, b, noises))``."""
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    def draw(sub, shapes):
        return _draw(sub, shapes, dtype, device)

    key, sub = keys.split(key)
    if isinstance(smp, MGMCSampler) and not (batch and not smp._graph()):
        return key, _cycle_noises(smp, 0, sub, tuple(batch), draw)
    return key, draw(sub, with_batch(smp.noise_shapes(), batch))


def _chains(t, lv: Level, cb: int):
    """Chain block ``cb`` of the trailing chain axis of ``t`` (all of it
    without a chain mesh axis)."""
    if not lv.chain_axis:
        return t
    m = t.shape[-1] // lv.n_chain_blocks
    return t.narrow(-1, cb * m, m)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


class StateLayout:
    """How a field of the finest level lies on the slots: :meth:`shard` a
    global tensor ``(*grid[, C])`` into one block a slot (flat mesh
    order), :meth:`unshard` the blocks back.  A tensor without the chain
    axis (a right-hand side shared by the chains) is split on its grid
    only."""

    def __init__(self, level: Level):
        self.level = level

    def _piece(self, x, key):
        dev, coords, cb = key
        t = self.level.block(x, coords)
        if x.ndim > len(self.level.grid_shape):
            t = _chains(t, self.level, cb)
        return t.to(dev, copy=True).contiguous()

    def shard(self, x) -> list:
        lv = self.level
        if x.ndim > len(lv.grid_shape) and lv.chain_axis and x.shape[-1] % lv.n_chain_blocks:
            raise ValueError(f"{x.shape[-1]} chains do not split over {lv.n_chain_blocks} chain slots")
        pieces = {k: self._piece(x, k) for k in lv.keys}
        return [pieces[k] for k in lv.slot_keys]

    def pieces(self, blocks) -> dict:
        """{piece key: block} of a list of slot blocks."""
        out = {}
        for k, b in zip(self.level.slot_keys, blocks):
            out.setdefault(k, b)
        return out

    def unshard(self, blocks, device=None):
        lv = self.level
        pieces = self.pieces(blocks)
        device = blocks[0].device if device is None else torch.device(device)
        parts = [assemble(lv, pieces, device, cb, 0) for cb in range(lv.n_chain_blocks)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


class ShardedSampler:
    """A Gibbs or MGMC sampler (every route plain) run on blocks of mesh
    slots: ``step_with_noise(xs, bs, noises)``, ``step(key, xs, bs)`` and
    ``noise_shapes()`` of the sampler it wraps, with x and b lists of slot
    blocks (:class:`StateLayout`; ``bs`` None: a zero right-hand side) and
    the noises global (each piece slices its block).  Built by
    :func:`.mesh.shard_sampler`."""

    def __init__(self, sampler, mesh: Mesh, levels):
        from parmgmc_tpu_torch.parallel.fused import on_devices

        self.sampler = sampler
        self.mesh = mesh
        self.levels = levels
        # a finest level no grid axis splits: each piece runs the sampler
        self.structured = bool(levels[0].split)
        self.layout = StateLayout(levels[0])
        self.is_mgmc = hasattr(sampler, "ops")
        home = canonical(sampler.device)
        if not self.structured:
            self.on = on_devices(sampler, [k[0] for k in levels[0].keys], home)
            return
        if self.is_mgmc:
            # the coarsest level's apply serves the W-cycle's coarse residual
            self.ops = [_LevelOp(lv, op, s) for lv, op, s in
                        zip(levels, sampler.ops, (*sampler.smoothers, None))]
            self.coarse = on_devices(sampler.coarse, [k[0] for k in levels[-1].keys], home)
        else:
            self.ops = [_LevelOp(levels[0], sampler.base, sampler)]

    @property
    def grid_shape(self):
        return self.sampler.grid_shape

    @property
    def dtype(self):
        return self.sampler.dtype

    def noise_shapes(self):
        return self.sampler.noise_shapes()

    # -- noise ---------------------------------------------------------------
    def _noise(self, lv: Level, t, key, lead: int):
        """A global noise leaf's part for a piece: its block and chain
        block, chains leading, on the piece's device."""
        t = _chains(lv.block(t, key[1]), lv, key[2])
        return (torch.movedim(t, -1, 0) if lead else t).to(key[0], non_blocking=True)

    # -- the cycle on pieces ---------------------------------------------------
    def _gibbs(self, l: int, x: dict, b: dict, nz, lead: int) -> dict:
        """One Gibbs step of level l's smoother (GibbsSampler.
        step_with_noise): fresh noise each half-sweep."""
        lop = self.ops[l]
        lv = self.levels[l]
        dirs = ("forward", "backward") if lop.sweep == "symmetric" else (lop.sweep,)
        for h, d in enumerate(dirs):
            bt = {}
            for k in x:
                eta = self._noise(lv, nz(k[0])[h]["eta"], k, lead)
                bt[k] = b[k] + lop.consts[k[:2]]["ns"] * eta
            x = lop.sweep_colours(bt, x, d)
        return x

    def _restrict(self, l: int, r: dict, lead: int) -> dict:
        lv, lvc = self.levels[l], self.levels[l + 1]
        tr = self.sampler.transfers[l]
        coarse = lv.with_grid(lvc.grid_shape)
        geometric = isinstance(tr, GeometricTransfer)
        if geometric:
            r = extend(lv, r, 1, lead, hi=False)
        out = {}
        for k, y in r.items():
            for ax in range(len(lv.grid_shape)):
                dim = lead + ax
                if not geometric:
                    y = _agg_down_1d(y, dim)
                elif ax in lv.split:
                    y = _restrict_block(y, dim, lv.last(k[1], ax))
                else:
                    y = _restrict_1d(y, dim)
            out[k] = y
        return relayout(coarse, out, lvc, lead)

    def _prolong(self, l: int, xc: dict, lead: int) -> dict:
        lv, lvc = self.levels[l], self.levels[l + 1]
        tr = self.sampler.transfers[l]
        coarse = lv.with_grid(lvc.grid_shape)
        c = relayout(lvc, xc, coarse, lead)
        geometric = isinstance(tr, GeometricTransfer)
        if geometric:
            c = extend(coarse, c, 1, lead, lo=False)
        out = {}
        for k, z in c.items():
            for ax in range(len(lv.grid_shape)):
                dim = lead + ax
                if not geometric:
                    z = _agg_up_1d(z, dim, lv.local[ax])
                elif ax in lv.split:
                    z = _prolong_block(z, dim, lv.last(k[1], ax))
                else:
                    z = _prolong_1d(z, dim, lv.grid_shape[ax])
            out[k] = z
        return out

    def _coarse_sample(self, b: dict, nz, lead: int) -> dict:
        """The coarsest level's exact samples, chain by chain (as the
        unsharded step takes them)."""
        lv = self.levels[-1]
        x = None
        for i in range(self.sampler.n_coarse):
            x = {}
            for k, bk in b.items():
                smp = self.coarse[k[0]]
                eta = nz(k[0])[i][0]["eta"]
                if not lead:
                    x[k] = smp.step_with_noise(None, bk, [{"eta": eta.to(k[0], non_blocking=True)}])
                    continue
                eta = torch.movedim(_chains(eta, lv, k[2]), -1, 0).to(k[0], non_blocking=True)
                x[k] = torch.stack([smp.step_with_noise(None, bk[c], [{"eta": eta[c]}])
                                    for c in range(bk.shape[0])])
        return x

    def _cycle(self, l: int, bl: dict, nz, lead: int) -> dict:
        """One stochastic cycle from zero at level l (MGMCSampler._cycle)."""
        smp = self.sampler
        if l == smp.n_levels - 1:
            return self._coarse_sample(bl, nz, lead)
        x = {k: torch.zeros_like(v) for k, v in bl.items()}
        for i in range(smp.n_pre):
            x = self._gibbs(l, x, bl, lambda d, i=i: nz(d)["pre"][i], lead)
        ax = self.ops[l].apply(x)
        r = self._restrict(l, {k: bl[k] - ax[k] for k in bl}, lead)
        xc = self._cycle(l + 1, r, lambda d: nz(d)["sub"][0], lead)
        for g in range(1, smp.gamma):  # W-cycle: iterate the coarse chain
            axc = self.ops[l + 1].apply(xc)
            dc = self._cycle(l + 1, {k: r[k] - axc[k] for k in r}, lambda d, g=g: nz(d)["sub"][g], lead)
            xc = {k: xc[k] + dc[k] for k in xc}
        p = self._prolong(l, xc, lead)
        x = {k: x[k] + p[k] for k in x}
        for i in range(smp.n_post):
            x = self._gibbs(l, x, bl, lambda d, i=i: nz(d)["post"][i], lead)
        return x

    # -- entry points -----------------------------------------------------------
    def _run(self, xs, bs, nz):
        lay = self.layout
        x = lay.pieces(xs)
        b = None if bs is None else lay.pieces(bs)
        lv0 = self.levels[0]
        d = len(lv0.grid_shape)
        if lv0.chain_axis and next(iter(x.values())).dim() == d:
            raise ValueError("a 'chain' mesh axis splits the trailing chain axis of x, which has none")
        if not self.structured:
            out = {}
            for k, v in x.items():
                tree = _tree_map(lambda t, k=k: _chains(t, lv0, k[2]).to(k[0], non_blocking=True), nz(k[0]))
                out[k] = self.on[k[0]].step_with_noise(v, None if b is None else b[k], tree)
            return [out[k] for k in lay.level.slot_keys]
        lead = 1 if next(iter(x.values())).dim() > d else 0

        def inside(t):  # chains leading
            return torch.movedim(t, -1, 0) if t.dim() > d else t

        x = {k: inside(v) for k, v in x.items()}
        b = {k: torch.zeros_like(v) for k, v in x.items()} if b is None else {k: inside(v) for k, v in b.items()}
        if self.is_mgmc:
            ax = self.ops[0].apply(x)
            y = self._cycle(0, {k: b[k] - ax[k] for k in x}, nz, lead)
            out = {k: x[k] + y[k] for k in x}
        else:
            out = self._gibbs(0, x, b, nz, lead)
        out = {k: (torch.movedim(v, 0, -1).contiguous() if lead else v) for k, v in out.items()}
        return [out[k] for k in lay.level.slot_keys]

    def step_with_noise(self, xs, bs, noises) -> list:
        """The wrapped sampler's ``step_with_noise`` on slot blocks, the
        noises global."""
        return self._run(xs, bs, lambda dev: noises)

    def step(self, key: int, xs, bs):
        """(key', xs'): the wrapped sampler's plain keyed step on slot
        blocks, bit for bit the unsharded one under the same key."""
        lv = self.levels[0]
        C = xs[0].shape[-1] * lv.n_chain_blocks if xs[0].dim() > len(lv.grid_shape) else None
        batch = () if C is None else (C,)
        trees = {}
        for dev in dict.fromkeys(k[0] for k in lv.keys):
            nkey, trees[dev] = keyed_noises(self.sampler, key, batch, xs[0].dtype, dev)
        return nkey, self._run(xs, bs, trees.__getitem__)


def _check_structured(smp):
    """Raise unless every level of ``smp`` is a plain Gibbs sweep of a
    stencil operator, every transfer geometric or aggregate and the
    coarsest sampler a dense Cholesky."""
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    smoothers = smp.smoothers if isinstance(smp, MGMCSampler) else (smp,)
    for s in smoothers:
        if not isinstance(s, GibbsSampler) or not isinstance(s.base, StencilOperator):
            raise ValueError(f"shard_sampler splits the grid of Gibbs sweeps of stencil operators, not "
                             f"{type(s).__name__}")
    if isinstance(smp, MGMCSampler):
        for t in smp.transfers:
            if not isinstance(t, (GeometricTransfer, AggregateTransfer)):
                raise ValueError(f"shard_sampler takes geometric or aggregate transfers, not {type(t).__name__}")
        if not isinstance(smp.coarse, CholeskySampler):
            raise ValueError("shard_sampler takes a dense Cholesky coarsest level, not "
                             f"{type(smp.coarse).__name__}")


def build(sampler, mesh: Mesh, grid_specs, grid_shapes) -> ShardedSampler:
    """The sharded sampler of a plain sampler: level l is split as
    ``grid_specs`` says while every finer level is and its blocks have
    even extents (the coarsest and the levels below the first unsplit one
    are replicated)."""
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    chain_axis = CHAIN_AXIS if CHAIN_AXIS in mesh.axis_names else None
    spec = dict(grid_specs)
    is_mgmc = isinstance(sampler, MGMCSampler)
    levels, split = [], True
    for l, shape in enumerate(grid_shapes):
        axes = spec.get(tuple(shape)) if split else None
        coarsest = is_mgmc and l == len(grid_shapes) - 1
        if axes is not None and not coarsest:
            lv = Level(mesh, shape, axes, chain_axis)
            if is_mgmc and any(lv.local[ax] % 2 for ax in lv.split):
                axes = None
        if axes is None or coarsest:
            axes, split = (None,) * len(shape), False
        levels.append(Level(mesh, shape, axes, chain_axis))
    if levels[0].split:
        _check_structured(sampler)
    return ShardedSampler(sampler, mesh, levels)
