"""Sharded MGMC chain step through the chain and sweep kernels (port of
``parmgmc_tpu.parallel.fused``).

Grid axis 0 is split into blocks over the slots of one mesh axis (see
:mod:`.mesh`).  Each block runs the same kernels the single-device chain
runs, on the block extended by halo planes from its neighbours; the
kernels key the red/black colouring, the FD diagonal, the axis-0
neighbour masks and the noise counter by GLOBAL row (``row_offset`` /
``n0_global`` in :mod:`~parmgmc_tpu_torch.kernels.rb_gibbs` and
:mod:`~parmgmc_tpu_torch.kernels.mg_sweep`), so a halo row recomputed on
two blocks holds the same bits on both and the kept rows equal the
single-device kernel's, bit for bit.

Layout of one V(1,0) chain step:

* level 0: a 4-plane halo of x and b, then the chain kernel (#1; #4 past
  the plane limit) on the extended block -- residual, noise, the
  pre-smooth from zero, the state add and the restriction in one launch;
  the halo rows' outputs are dropped (even halos keep the 2x2x2
  aggregates of the restriction inside one block);
* the other sharded levels: a 2-plane halo of the level's right-hand
  side, then the from-zero level kernel (#3);
* below ``min_local`` rows a block (or where :func:`_level_shardable`
  refuses a level): the level's right-hand side is gathered (it is
  small) and the rest of the cycle runs replicated, once on each distinct
  device, on the sampler's own explicit-noise cycle with identical noise
  -- the reference's coarsening onto one rank (``src/pc_chols.c:38-47``)
  without idle ranks;
* up: the aggregate prolongation is block-local.

On an LRC (posterior) operator level 0 runs the kernel on the base
stencil with the rank-k terms as block-local contractions of the dense
(*grid, k) factors and one :func:`~.mesh.psum` each (JAX's dense
distribution of the single-device correction, not the probed windows of
``MGMCSampler``), and the tail starts at level 1.

Requirements (raised): V(1,0) cycles (n_pre = 1, n_post = 0, gamma = 1)
whose level 0 :func:`_level_shardable` admits.
"""

from __future__ import annotations

import dataclasses

import torch

from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.kernels.mg_sweep import (
    chain_down_2d_supported,
    fused_chain_down_2d,
    fused_chain_down_fd,
    fused_zero_gibbs_restrict_fd,
)
from parmgmc_tpu_torch.kernels import rb_gibbs
from parmgmc_tpu_torch.kernels import _twin
from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.operators.stencil import FDStencilOperator
from parmgmc_tpu_torch.operators.transfer import AggregateTransfer
from parmgmc_tpu_torch.parallel.mesh import Mesh, all_gather, canonical, exchange_planes, psum, shard_array
from parmgmc_tpu_torch.samplers.gibbs import _draw, _lowrank_draw
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

__all__ = ["make_sharded_mgmc_step", "sharded_fused_gibbs_sweep"]


def _extend(blocks, h: int) -> list:
    """Each block with ``h`` halo planes of its neighbours on each side
    (zeros at the chain ends); None blocks stay None (no b stream)."""
    if blocks[0] is None:
        return list(blocks)
    return [torch.cat([lo, v, hi], dim=0) for v, (lo, hi) in zip(blocks, exchange_planes(blocks, h))]


def sharded_fused_gibbs_sweep(xs, bs, coeffs, kappa2, hinv2, omega, seed, step,
                              sweep: str = "forward", noise_mult=1.0,
                              with_noise: bool = True) -> list:
    """One red/black Gibbs sweep of the FD operator (kappa2, hinv2) on the
    blocks ``xs`` (``bs`` None: zero right-hand side): a 2-plane halo of x
    and b, the sweep kernel (#7; #8 past the plane limit) on each
    extended block with global-row keying, the block's own rows kept.

    Exact: a kept row's colour-1 update reads the colour-0 halo row, which
    the block recomputes from pre-sweep x at distance <= 2 and the
    globally keyed b~, the values the owning block computes; so the
    result is the single-device sweep's."""
    n_loc = xs[0].shape[0]
    bs = bs or [None] * len(xs)
    return [
        rb_gibbs.fused_rb_gibbs_sweep_fd(
            x, b, coeffs, kappa2, hinv2, omega, seed, step, noise_mult, sweep=sweep,
            with_noise=with_noise, row_offset=i * n_loc - 2, n0_global=n_loc * len(xs))[2:-2]
        for i, (x, b) in enumerate(zip(_extend(xs, 2), _extend(bs, 2)))
    ]


def _sharded_zero_down(bls, p, seed, step, with_noise):
    """(ys, rcs): a level's down-phase from zero on each block (#3).  Only
    the level's right-hand side needs halos (the pre-smooth starts from
    zero): one 2-plane exchange feeds the sweep, the residual and the
    restriction; the halo rows' coarse images are dropped."""
    n_loc = bls[0].shape[0]
    ys, rcs = [], []
    for i, b in enumerate(_extend(bls, 2)):
        y, rc = fused_zero_gibbs_restrict_fd(
            b, p["coeffs"], p["kappa2"], p["hinv2"], p["omega"], seed, step, sweep=p["sweep"],
            with_noise=with_noise, row_offset=i * n_loc - 2, n0_global=p["n0_global"])
        ys.append(y[2:-2])
        rcs.append(rc[1:-1])
    return ys, rcs


def _sharded_chain_down(xs, bs, p, seed, step, with_noise):
    """(xpys, rcs): the chain down-phase on each block -- residual, noise,
    the pre-smooth from zero, the state add and the restriction in one
    launch (#1; #4 past the plane limit), as on one device.  The r -> y ->
    r - A y chain reads three rings, so a 4-plane halo of x and b (even:
    the noise keys and the 2x2x2 aggregates stay globally aligned) feeds
    the kernel; the halo rows' outputs are dropped."""
    n_loc, n1, n2 = xs[0].shape
    fn = fused_chain_down_fd if n1 * n2 <= rb_gibbs._PLANE_LIMIT else fused_chain_down_2d
    xpys, rcs = [], []
    for i, (x, b) in enumerate(zip(_extend(xs, 4), _extend(bs, 4))):
        xpy, rc = fn(x, b, p["coeffs"], p["kappa2"], p["hinv2"], p["omega"], seed, step,
                     sweep=p["sweep"], with_noise=with_noise, row_offset=i * n_loc - 4,
                     n0_global=p["n0_global"])
        xpys.append(xpy[4:-4])
        rcs.append(rc[2:-2])
    return xpys, rcs


def _local_fd_apply(x_loc, lo1, hi1, coeffs, kappa2, hinv2, row0: int, n0_global: int):
    """(A x) on a block of the FD star operator given its 1-plane halos
    ``lo1``, ``hi1`` (zero at the global ends, the FD boundary); the
    diagonal is the link-count formula on GLOBAL rows (the block's first
    row is global row ``row0``)."""
    dt, dev = x_loc.dtype, x_loc.device
    rows = _twin.Rows(x_loc.shape[0], row0, n0_global)
    diag = _twin.fd_diag(tuple(x_loc.shape), kappa2, hinv2, dt, dev, rows)
    c = [_twin.scalar(v, dt, dev) for v in coeffs]
    return diag * x_loc + _twin.star_neigh(torch.cat([lo1, x_loc, hi1]), c)[1:-1]


def _level_shardable(sampler, l: int, n_dev: int, min_local: int) -> bool:
    """Can level l run block-wise on ``n_dev`` blocks?  JAX's rule: a 3D
    link-count FD smoother on the kernels, an aggregation transfer, rows a
    block a multiple of 4 and at least ``min_local``, even extents, the
    lane extent n2 a multiple of 128, and planes within the plane limit
    (level 0: or a block the marching chain kernel takes).  The n2 % 128
    and plane rules are the TPU kernels' (VMEM, lane width), kept so that
    the same levels are sharded as in JAX; not measured on the H100
    (ROADMAP slice 2c)."""
    op = sampler.ops[l]
    s = sampler.smoothers[l]
    if len(op.grid_shape) != 3:
        return False
    n0, n1, n2 = op.grid_shape
    n_loc = n0 // n_dev
    return (
        getattr(s, "fd_params", None) is not None
        and getattr(s, "has_kernel", False)
        and isinstance(sampler.transfers[l], AggregateTransfer)
        and n0 % n_dev == 0
        and n_loc % 4 == 0
        and n_loc >= min_local
        and n1 % 2 == 0
        and n2 % 2 == 0
        and n2 % 128 == 0
        and (n1 * n2 <= rb_gibbs._PLANE_LIMIT if l > 0
             else n1 * n2 <= rb_gibbs._PLANE_LIMIT
             or chain_down_2d_supported((n_loc + 8, n1, n2)))
    )


def _tail_shapes(sampler, l: int):
    """The noise shapes of the cycle from level l down (the replicated
    tail's draws)."""
    if l == sampler.n_levels - 1:
        return [sampler.coarse.noise_shapes() for _ in range(sampler.n_coarse)]
    s = sampler.smoothers[l]
    return {
        "pre": [s.noise_shapes() for _ in range(sampler.n_pre)],
        "sub": [_tail_shapes(sampler, l + 1)],
        "post": [s.noise_shapes() for _ in range(sampler.n_post)],
    }


def _to_device(obj, device, moved=None):
    """A copy of a sampler's tree (dataclasses, tuples, lists, dicts of
    tensors) with every tensor on ``device``; tensors already there are
    shared, and a tensor the tree holds twice (B and its column stack)
    is copied once."""
    moved = {} if moved is None else moved
    if isinstance(obj, torch.Tensor):
        if id(obj) not in moved:
            moved[id(obj)] = obj.to(device)
        return moved[id(obj)]
    if isinstance(obj, FDStencilOperator):
        return FDStencilOperator(obj.kappa2, obj.hinv2, obj.grid_shape, obj.dtype, device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device, moved) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device, moved) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to_device(getattr(obj, f.name), device, moved)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def on_devices(obj, devices, home) -> dict:
    """{device: obj on it} for each distinct device of ``devices``: obj
    itself on ``home`` (its own device), a copy of its tensors elsewhere."""
    return {d: obj if d == home else _to_device(obj, d) for d in dict.fromkeys(devices)}


def _zeros(shapes, dtype, device):
    if isinstance(shapes, tuple):
        return torch.zeros(shapes, dtype=dtype, device=device)
    if isinstance(shapes, dict):
        return {k: _zeros(v, dtype, device) for k, v in shapes.items()}
    return [_zeros(v, dtype, device) for v in shapes]


def make_sharded_mgmc_step(sampler: MGMCSampler, mesh: Mesh, axis_name: str = "x",
                           min_local: int = 8, with_noise: bool = True):
    """step(key, xs, bs) -> (key, xs'): the sampler's V(1,0) chain step on
    blocks of grid axis 0 over the slots of ``axis_name`` (``xs``, ``bs``
    lists of blocks from :func:`~.mesh.shard_array`; ``bs`` None is a zero
    right-hand side).  ``with_noise=False`` is the deterministic
    multigrid iteration: every kernel's draw and every tail draw zero.

    Keys are split as JAX's step splits them, ``keys.split(key, 4)``: the
    per-level (seed, step) pairs of the kernels, the tail's noise (drawn
    once on the first slot's device, copied to each distinct device), and
    the posterior's k low-rank draws.  A step reads nothing back from a
    device."""
    if not (sampler.n_pre == 1 and sampler.n_post == 0 and sampler.gamma == 1):
        raise ValueError("the sharded MGMC step runs V(1,0) cycles (n_pre=1, n_post=0, gamma=1)")
    is_lrc = isinstance(sampler.ops[0], LRCOperator)
    if is_lrc and sampler.lrc_aux is None:
        raise ValueError("the sharded posterior step needs the rank-k matrices (compute_lrc_aux: "
                         "a forward or backward level-0 smoother on the kernels)")
    slots = [canonical(s) for s in mesh.slots(axis_name)]
    n_dev = len(slots)
    n_sh = 0
    while n_sh < sampler.n_levels - 1 and _level_shardable(sampler, n_sh, n_dev, min_local):
        n_sh += 1
    if is_lrc:  # only level 0 carries the rank-k correction; the tail is exact LRC
        n_sh = min(n_sh, 1)
    if n_sh == 0:
        raise ValueError(
            f"fine level {tuple(sampler.ops[0].grid_shape)} not shardable over {n_dev} blocks "
            f"(needs rows % (4*{n_dev}) == 0, FD form on the kernels, aggregation transfers, "
            "lane dim % 128)")
    lvl = []
    for l in range(n_sh):
        s = sampler.smoothers[l]
        gs = tuple(sampler.ops[l].grid_shape)
        lvl.append(dict(
            coeffs=s._coeff6(), kappa2=s.fd_params[0], hinv2=s.fd_params[1], omega=s.omega,
            sweep=s.sweep, n0_global=gs[0], local=AggregateTransfer(
                fine_shape=(gs[0] // n_dev, *gs[1:])),
        ))
    tail = MGMCSampler(
        ops=sampler.ops[n_sh:], transfers=sampler.transfers[n_sh:],
        smoothers=sampler.smoothers[n_sh:], coarse=sampler.coarse, n_pre=sampler.n_pre,
        n_post=sampler.n_post, n_levels=sampler.n_levels - n_sh, n_coarse=sampler.n_coarse,
    )
    devices = list(dict.fromkeys(slots))
    tails = on_devices(tail, devices, canonical(sampler.device))
    tail_shapes = _tail_shapes(sampler, n_sh)
    dtype = sampler.dtype

    if is_lrc:
        op0, s0 = sampler.ops[0], sampler.smoothers[0]
        # the (*grid, k) factors in blocks, the k-sized ones on each slot
        B_l = shard_array(op0.B, mesh, axis_name=axis_name)
        Bb_l = shard_array(s0.woodbury().dense, mesh, axis_name=axis_name)
        RABb_l = shard_array(sampler.lrc_aux.RABb, mesh, axis_name=axis_name)
        Bc_l = shard_array(sampler.ops[1].B, mesh, axis_name=axis_name)
        rep = {d: (op0.sigma_inv.to(d), sampler.lrc_aux.H.to(d)) for d in devices}
        sqrt_sig = s0.sqrt_sigma_inv.to(slots[0])
    ax3 = ([0, 1, 2], [0, 1, 2])

    def step(key: int, xs, bs):
        key, ks, kn, kw = keys.split(key, 4)
        sk = keys.split(ks, 2 * n_sh)
        seeds = [(keys.randint31(sk[2 * l]), keys.randint31(sk[2 * l + 1])) for l in range(n_sh)]
        if with_noise:
            noises = _draw(kn, tail_shapes, dtype, slots[0])
        else:
            noises = _zeros(tail_shapes, dtype, slots[0])
        noise_on = {d: _to_device(noises, d) for d in devices}
        if bs is None:
            bs = [None] * n_dev

        if is_lrc:
            # the rank-k terms: block-local contractions, one psum each
            k = op0.k
            w = (_lowrank_draw(keys.generator(kw, sqrt_sig.device), sqrt_sig, 1)[0] if with_noise
                 else torch.zeros(k, dtype=dtype, device=slots[0]))
            ws = [w.to(d, non_blocking=True) for d in slots]
            btx = psum([torch.tensordot(B, x, dims=ax3) for B, x in zip(B_l, xs)])
            bs = [B @ (wd - rep[d][0] * t) if b is None else b + B @ (wd - rep[d][0] * t)
                  for B, b, wd, t, d in zip(B_l, bs, ws, btx, slots)]

        p0 = lvl[0]
        xpy, bl = _sharded_chain_down(xs, bs, p0, *seeds[0], with_noise)

        if is_lrc:
            # the kernel's restricted residual corrected, and the
            # Woodbury state correction
            u = psum([torch.tensordot(B, y, dims=ax3) for B, y in zip(B_l, xpy)])
            c = [ui - t for ui, t in zip(u, btx)]
            cc = [wd + rep[d][0] * (ci - rep[d][1] @ ci) for wd, ci, d in zip(ws, c, slots)]
            bl = [r + R @ ci - Bc @ cci for r, R, Bc, ci, cci in zip(bl, RABb_l, Bc_l, c, cc)]
            xpy = [y - Bb @ ci for y, Bb, ci in zip(xpy, Bb_l, c)]

        ys = []
        for l in range(1, n_sh):
            y, bl = _sharded_zero_down(bl, lvl[l], *seeds[l], with_noise)
            ys.append(y)

        # the replicated tail: the small level-n_sh right-hand side
        # gathered, the cycle run once a device with the same noise
        full = all_gather(bl)
        zs = {}
        for d, f in zip(slots, full):
            if d not in zs:
                zs[d] = tails[d]._cycle(0, f, noise_on[d])
        rows = bl[0].shape[0]
        z = [zs[d][i * rows:(i + 1) * rows] for i, d in enumerate(slots)]

        for l in reversed(range(1, n_sh)):
            z = [lvl[l]["local"].prolong_add(y, zi) for y, zi in zip(ys[l - 1], z)]
        return key, [p0["local"].prolong_add(y, zi) for y, zi in zip(xpy, z)]

    return step
