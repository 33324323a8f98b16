"""Row-partitioned domain decomposition of unstructured meshes (port of
``parmgmc_tpu.parallel.graph_sharded``).

The reference row-partitions mesh matrices over MPI ranks and sweeps with
per-colour ghost scatters (``mc_sor.c:298-381``); ``ex13.py`` weak-scales
the wrench that way.  Here the ranks are the slots of a :class:`~.mesh.
Mesh`, driven from one process:

* **partition** (:func:`partition_graph_operator`, host set-up, the JAX
  function step by step): owned rows by a balanced cut along the widest
  coordinate axis (or the original node order), stored per slot as a
  colour-blocked ELL with UNIFORM padded colour extents; padding rows are
  inert self-loops (diagonal 1, values 0, never read);
* **ghosts**: ``"neighbor"`` mode ships, for each nonzero slot offset d,
  slot s's export block to slot (s - d) mod S (the JAX ``ppermute``; a
  copy between the slots' devices), so a slot receives
  O(neighbours x boundary) rows; ``"allgather"`` gives every slot every
  slot's padded boundary (:func:`~.mesh.all_gather`).  Ghost columns index
  ``[local rows, exchanged exports]``;
* **coarse levels** are replicated, run once a distinct device:
  restriction is a per-slot partial P^T over owned rows plus one
  :func:`~.mesh.psum`, prolongation a local row gather.

Within a colour the multicolour Gauss-Seidel updates are independent and
the ghosts are refreshed at every colour, so the sharded sweep is the
single-device sweep; the deterministic sharded MGMC cycle equals the
single-device ``step_with_noise`` with zero noises, to roundoff.

A sharded vector is a list of per-slot tensors ``(L, [C])`` on the slots'
devices (chain-major with a trailing chain axis); :func:`to_local`,
:func:`to_global` and :func:`rows_to_local` also take and give the JAX
package's stacked ``(S, L, [C])`` layout (``stacked=True``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.kernels._twin import noise_factor
from parmgmc_tpu_torch.operators.graph import GraphOperator, bcast
from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.parallel.mesh import Mesh, all_gather, canonical, psum
from parmgmc_tpu_torch.samplers.gibbs import with_batch

__all__ = [
    "ShardedGraphOperator",
    "GraphLayout",
    "partition_graph_operator",
    "to_local",
    "to_global",
    "rows_to_local",
    "sharded_sor_sweep",
    "sharded_apply",
    "make_sharded_graph_gibbs_step",
    "make_sharded_graph_mgmc_step",
]


@dataclass(frozen=True, eq=False)
class _Slot:
    """One slot's block of the partition, on the slot's device."""

    device: torch.device
    vals: torch.Tensor  # (L, w)
    cols: torch.Tensor  # (L, w) int64 into [0, L + ghosts)
    diag: torch.Tensor  # (L,)
    export_idx: torch.Tensor  # (bmax,) or (m, bmax) int64 local rows
    own_mask: torch.Tensor  # (L,)


@dataclass(frozen=True, eq=False)
class ShardedGraphOperator:
    """Per-slot colour-blocked ELL blocks of a GraphOperator.

    The host arrays carry the JAX package's layout with a leading slot
    axis (``vals``, ``cols``, ``diag``, ``export_idx``, ``own_gid``,
    ``own_mask``, numpy); ``slots`` holds each slot's block as tensors on
    its device.  ``export_idx`` is (S, bmax) in ``"allgather"`` mode and
    (S, m, bmax) in ``"neighbor"`` mode, row j listing the rows slot s
    ships to slot s - nbr_shifts[j]."""

    vals: np.ndarray  # (S, L, w)
    cols: np.ndarray  # (S, L, w) int32
    diag: np.ndarray  # (S, L)
    export_idx: np.ndarray
    own_gid: np.ndarray  # (S, L) int32 global internal id (0 for padding)
    own_mask: np.ndarray  # (S, L) float32: 1 real row, 0 padding
    color_starts: tuple
    n_shards: int
    bmax: int
    n_local: int
    ghost_mode: str
    nbr_shifts: tuple
    slots: tuple = ()

    @property
    def ncolors(self) -> int:
        return len(self.color_starts) - 1

    @property
    def ghost_rows_received(self) -> int:
        """Ghost rows a slot receives an exchange: O(neighbours) in
        ``"neighbor"`` mode, O(S) in ``"allgather"`` mode."""
        if self.ghost_mode == "neighbor":
            return len(self.nbr_shifts) * self.bmax
        return self.n_shards * self.bmax

    @property
    def devices(self) -> list:
        return [s.device for s in self.slots]


def partition_graph_operator(op: GraphOperator, n_shards: int, coords=None,
                             ghost_mode: str = "neighbor", devices=None) -> ShardedGraphOperator:
    """Row-partition a colour-blocked GraphOperator into ``n_shards``.

    ``coords`` (n, d), the points in the op's ORIGINAL node order, select
    a balanced widest-axis cut; without them the original node index
    orders the cut.  ``devices`` lists the slots' devices (the op's
    device for every slot by default).  Host set-up."""
    if ghost_mode not in ("neighbor", "allgather"):
        raise ValueError(f"unknown ghost_mode {ghost_mode!r} (neighbor or allgather)")
    n = op.n
    vals = op.vals.detach().cpu().numpy()
    cols = op.cols.detach().cpu().numpy()
    diag = op.diag.detach().cpu().numpy()
    perm = op.perm.detach().cpu().numpy()
    starts = op.color_starts
    ncolors = op.ncolors

    color_of = np.empty(n, np.int32)
    for c in range(ncolors):
        color_of[starts[c] : starts[c + 1]] = c

    # owner: balanced cut along the widest coordinate axis
    if coords is not None:
        ci = np.asarray(coords)[perm]  # internal ordering
        axis = int(np.argmax(ci.max(0) - ci.min(0)))
        order = np.argsort(ci[:, axis], kind="stable")
    else:
        order = np.argsort(perm, kind="stable")  # original-index locality
    owner = np.empty(n, np.int32)
    bounds = [(n * s) // n_shards for s in range(n_shards + 1)]
    for s in range(n_shards):
        owner[order[bounds[s] : bounds[s + 1]]] = s

    # local layouts: per shard, owned rows sorted by (colour, gid); per-colour
    # extents padded to the max over shards
    owned = [np.where(owner == s)[0] for s in range(n_shards)]
    by_color = [[gs[color_of[gs] == c] for c in range(ncolors)] for gs in owned]
    rmax = [max(len(by_color[s][c]) for s in range(n_shards)) for c in range(ncolors)]
    lstarts = np.concatenate([[0], np.cumsum(rmax)]).astype(int)
    L = int(lstarts[-1])

    # global internal id -> (owner, local slot)
    slot_of = np.empty(n, np.int64)
    own_gid = np.zeros((n_shards, L), np.int32)
    own_mask = np.zeros((n_shards, L), np.float32)
    for s in range(n_shards):
        for c in range(ncolors):
            gs = by_color[s][c]
            sl = lstarts[c] + np.arange(len(gs))
            slot_of[gs] = sl
            own_gid[s, sl] = gs
            own_mask[s, sl] = 1.0

    # boundary exports: owned gids referenced by another shard
    w = vals.shape[1]
    ref_mask = vals != 0
    pair_need = [[None] * n_shards for _ in range(n_shards)]  # [t][s]
    for t in range(n_shards):
        gt = owned[t]
        nb = cols[gt][ref_mask[gt]]
        for s in range(n_shards):
            if t != s:
                pair_need[t][s] = np.unique(nb[owner[nb] == s])

    if ghost_mode == "neighbor":
        # per-offset export lists: shard s ships lists[d][s] to (s - d)
        shifts = [d for d in range(1, n_shards)
                  if any(len(pair_need[(s - d) % n_shards][s]) for s in range(n_shards))]
        lists = {d: [np.sort(pair_need[(s - d) % n_shards][s]) for s in range(n_shards)] for d in shifts}
        bmax = max([1] + [len(e) for d in shifts for e in lists[d]])
        m = max(1, len(shifts))
        export_idx = np.zeros((n_shards, m, bmax), np.int32)
        # pos_nbr[j, g]: position of gid g in owner(g)'s delta_j list
        pos_nbr = np.zeros((m, n), np.int64)
        for j, d in enumerate(shifts):
            for s in range(n_shards):
                e = lists[d][s]
                export_idx[s, j, : len(e)] = slot_of[e]
                pos_nbr[j, e] = np.arange(len(e))
        j_of_delta = np.zeros(n_shards, np.int64)
        for j, d in enumerate(shifts):
            j_of_delta[d] = j
    else:
        exports = []
        for s in range(n_shards):
            need = [pair_need[t][s] for t in range(n_shards) if t != s]
            exports.append(np.unique(np.concatenate(need)) if need else np.empty(0, np.int64))
        bmax = max(1, max(len(e) for e in exports))
        export_idx = np.zeros((n_shards, bmax), np.int32)
        pos_in_export = np.full(n, -1, np.int64)
        for s in range(n_shards):
            export_idx[s, : len(exports[s])] = slot_of[exports[s]]
            pos_in_export[exports[s]] = np.arange(len(exports[s]))
        shifts = []

    # per-shard ELL with ghost-mapped columns; padding rows are self-loops
    vals_sh = np.zeros((n_shards, L, w), vals.dtype)
    cols_sh = np.zeros((n_shards, L, w), np.int32)
    diag_sh = np.ones((n_shards, L), diag.dtype)
    for s in range(n_shards):
        cols_sh[s] = np.arange(L, dtype=np.int32)[:, None]
        gs = np.where(own_mask[s] > 0)[0]
        gids = own_gid[s, gs]
        vals_sh[s, gs] = vals[gids]
        diag_sh[s, gs] = diag[gids]
        cg = cols[gids]
        local = owner[cg] == s
        if ghost_mode == "neighbor":
            jj = j_of_delta[(owner[cg] - s) % n_shards]
            ghost = L + jj * bmax + pos_nbr[jj, cg]
        else:
            ghost = L + owner[cg] * bmax + pos_in_export[cg]
        mapped = np.where(local, slot_of[cg], ghost)
        # unreferenced (zero-valued) ELL entries map to the row itself
        mapped = np.where(ref_mask[gids], mapped, gs[:, None])
        cols_sh[s, gs] = mapped.astype(np.int32)

    devices = [canonical(d) for d in (devices if devices is not None else [op.device] * n_shards)]
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    dt = op.dtype
    slots = tuple(
        _Slot(device=d,
              vals=torch.as_tensor(vals_sh[s], device=d).to(dt),
              cols=torch.as_tensor(cols_sh[s].astype(np.int64), device=d),
              diag=torch.as_tensor(diag_sh[s], device=d).to(dt),
              export_idx=torch.as_tensor(export_idx[s].astype(np.int64), device=d),
              own_mask=torch.as_tensor(own_mask[s], device=d).to(dt))
        for s, d in enumerate(devices)
    )
    return ShardedGraphOperator(
        vals=vals_sh, cols=cols_sh, diag=diag_sh, export_idx=export_idx, own_gid=own_gid,
        own_mask=own_mask, color_starts=tuple(int(v) for v in lstarts), n_shards=int(n_shards),
        bmax=int(bmax), n_local=L, ghost_mode=ghost_mode, nbr_shifts=tuple(int(d) for d in shifts),
        slots=slots,
    )


# -- global <-> local layout (host/eager helpers) ------------------------------
def _mask_rows(out, mask):
    return out * mask.reshape(mask.shape + (1,) * (out.ndim - mask.ndim)).to(out.dtype)


def to_local(spec: ShardedGraphOperator, v, stacked: bool = False):
    """(n, [C]) internal-ordered vector -> per-slot blocks (L, [C]) on the
    slots' devices, padding rows zero; ``stacked``: one (S, L, [C]) tensor
    on v's device."""
    gid = torch.as_tensor(spec.own_gid.reshape(-1).astype(np.int64), device=v.device)
    mask = torch.as_tensor(spec.own_mask, device=v.device)
    out = _mask_rows(v[gid].reshape((spec.n_shards, spec.n_local) + tuple(v.shape[1:])), mask)
    if stacked:
        return out
    return [out[s].to(sl.device).contiguous() for s, sl in enumerate(spec.slots)]


def to_global(spec: ShardedGraphOperator, vl, n: int, device=None):
    """Per-slot blocks (or the stacked (S, L, [C]) tensor) -> the (n, [C])
    internal-ordered vector, on ``device`` (the first block's by default)."""
    if isinstance(vl, (list, tuple)):
        device = vl[0].device if device is None else device
        vl = torch.stack([v.to(device) for v in vl])
    elif device is not None:
        vl = vl.to(device)
    flat = vl.reshape((spec.n_shards * spec.n_local,) + tuple(vl.shape[2:]))
    gid = torch.as_tensor(spec.own_gid.reshape(-1).astype(np.int64), device=vl.device)
    mask = torch.as_tensor(spec.own_mask.reshape(-1), device=vl.device)
    out = torch.zeros((n,) + tuple(vl.shape[2:]), dtype=vl.dtype, device=vl.device)
    return out.index_add_(0, gid, _mask_rows(flat, mask))


def rows_to_local(spec: ShardedGraphOperator, M, stacked: bool = False):
    """(n, k) row matrix -> per-slot row blocks (L, k), padding rows zero
    (the LRC pieces B and Bb, whose rows live on the fine grid: a
    shard-local product then needs one psum a k-vector)."""
    return to_local(spec, M, stacked)


@dataclass(frozen=True, eq=False)
class GraphLayout:
    """The state layout of a sharded graph step: :meth:`shard` a global
    (n, [C]) internal-ordered vector into per-slot blocks, :meth:`unshard`
    them back."""

    spec: ShardedGraphOperator
    n: int

    def shard(self, v) -> list:
        return to_local(self.spec, v)

    def unshard(self, blocks, device=None):
        return to_global(self.spec, blocks, self.n, device)


# -- slot-local compute ---------------------------------------------------------
def _gather_exports(spec: ShardedGraphOperator, xs) -> list:
    """Each slot's extended vector ``[local, ghosts]`` for one colour.

    neighbor mode: for each shift d, slot s's export block goes to slot
    (s - d) mod S; allgather mode: every slot's padded boundary, in slot
    order."""
    S = spec.n_shards
    if spec.ghost_mode == "neighbor":
        blocks = [[x[sl.export_idx[j]] for sl, x in zip(spec.slots, xs)]
                  for j in range(len(spec.nbr_shifts))]
        out = []
        for t, (sl, x) in enumerate(zip(spec.slots, xs)):
            parts = [x] + [blocks[j][(t + d) % S].to(sl.device, non_blocking=True)
                           for j, d in enumerate(spec.nbr_shifts)]
            if len(parts) == 1:  # one shard / no cross-shard references
                parts.append(x.new_zeros((spec.bmax,) + tuple(x.shape[1:])))
            out.append(torch.cat(parts, dim=0))
        return out
    tables = all_gather([x[sl.export_idx] for sl, x in zip(spec.slots, xs)])
    return [torch.cat([x, tab], dim=0) for x, tab in zip(xs, tables)]


def _ell(vals, cols, x):
    """sum_k vals[:, k] x[cols[:, k]] for x (n,) or chain-major (n, C)."""
    g = x[cols]  # (rows, w, [C])
    return (bcast(vals, g) * g).sum(dim=1)


def _local_ell_sums(sl: _Slot, xe, s: int, e: int):
    return _ell(sl.vals[s:e], sl.cols[s:e], xe)


def sharded_sor_sweep(spec: ShardedGraphOperator, bs, xs, omega, sweep: str = "forward") -> list:
    """Multicolour SOR sweep on the per-slot blocks with a ghost refresh
    before every colour (forward: colour order, backward: reversed,
    symmetric: forward then backward) -- the single-device sweep.  ``bs``
    blocks may lack the chain axis of ``xs``."""
    if sweep == "symmetric":
        xs = sharded_sor_sweep(spec, bs, xs, omega, "forward")
        return sharded_sor_sweep(spec, bs, xs, omega, "backward")
    if sweep not in ("forward", "backward"):
        raise ValueError(f"unknown sweep {sweep!r}")
    order = range(spec.ncolors) if sweep == "forward" else reversed(range(spec.ncolors))
    xs = [x.clone() for x in xs]
    for c in order:
        s, e = spec.color_starts[c], spec.color_starts[c + 1]
        if s == e:
            continue
        xe = _gather_exports(spec, xs)
        for sl, x, b, ext in zip(spec.slots, xs, bs, xe):
            sums = _local_ell_sums(sl, ext, s, e)
            x[s:e] = (1.0 - omega) * x[s:e] + bcast(omega / sl.diag[s:e], x) * (bcast(b[s:e], x) - sums)
    return xs


def sharded_apply(spec: ShardedGraphOperator, xs) -> list:
    """A x on the per-slot blocks (one ghost exchange)."""
    xe = _gather_exports(spec, xs)
    return [bcast(sl.diag, x) * x + _local_ell_sums(sl, ext, 0, spec.n_local)
            for sl, x, ext in zip(spec.slots, xs, xe)]


def _axis_slots(mesh: Mesh, axis_name: str) -> list:
    return [canonical(d) for d in mesh.slots(axis_name)]


def _zeros_rhs(xs, bs):
    return [torch.zeros_like(x) for x in xs] if bs is None else bs


# -- samplers -------------------------------------------------------------------
def make_sharded_graph_gibbs_step(op: GraphOperator, mesh: Mesh, omega: float = 1.0,
                                  sweep: str = "forward", coords=None, axis_name: str = "x",
                                  n_chains: int = 0, ghost_mode: str = "neighbor"):
    """(step, spec, layout): a sharded Gibbs chain step.

    step(key, xs, bs) -> (key, xs') on per-slot blocks (L, [C])
    (``n_chains > 0``: the trailing chain axis; ``bs`` None is a zero
    right-hand side).  It targets N(A^{-1} b, A^{-1}) exactly: the sweep
    is the single-device sweep, and each slot draws its rows' noise from
    its own stream, ``keys.fold_in(key, slot)``, fresh each half-sweep
    (``keys.fold_in(., i)``); padding rows draw noise nothing reads."""
    slots = _axis_slots(mesh, axis_name)
    spec = partition_graph_operator(op, len(slots), coords=coords, ghost_mode=ghost_mode, devices=slots)
    om = float(torch.tensor(float(omega), dtype=op.dtype))
    nf = noise_factor(om, op.dtype)
    nsc = [nf * torch.sqrt(sl.diag) for sl in spec.slots]
    batch = (n_chains,) if n_chains else ()
    dirs = ["forward", "backward"] if sweep == "symmetric" else [sweep]

    def step(key: int, xs, bs):
        key, sub = keys.split(key)
        bs = _zeros_rhs(xs, bs)
        for i, d in enumerate(dirs):
            bt = []
            for t, (sl, b, ns) in enumerate(zip(spec.slots, bs, nsc)):
                g = keys.generator(keys.fold_in(keys.fold_in(sub, t), i), sl.device)
                eta = torch.randn((spec.n_local,) + batch, generator=g, dtype=op.dtype, device=sl.device)
                bt.append(bcast(b, eta) + bcast(ns, eta) * eta)
            xs = sharded_sor_sweep(spec, bt, xs, om, d)
        return key, xs

    return step, spec, GraphLayout(spec, op.n)


def make_sharded_graph_mgmc_step(sampler, mesh: Mesh, coords=None, axis_name: str = "x",
                                 n_chains: int = 0, with_noise: bool = True,
                                 ghost_mode: str = "neighbor"):
    """(step, spec, layout): the sharded MGMC V-cycle chain step of an
    algebraic (GraphOperator) hierarchy -- level 0 row-partitioned with
    per-colour ghost exchanges, levels 1.. replicated (run once a distinct
    device; they shrink ~25x a level).

    step(key, xs, bs) -> (key, xs').  With zero noises
    (``with_noise=False``) the cycle equals the single-device
    ``step_with_noise``.  The keyed step draws level-0 noise per slot
    (``keys.fold_in(key, slot + 1)``) and everything replicated from the
    shared key ``keys.fold_in(key, 0)``: the coarse cycle (the sampler's
    own keyed cycle over levels 1.., identical on every device) and the
    posterior's k low-rank draws.

    On an LRC (posterior) hierarchy level 0 row-shards B and the
    smoother's Woodbury factors Bb (:func:`rows_to_local`); each
    half-sweep adds the low-rank noise B sqrt(Sigma^{-1}) eta2 and applies
    x <- x - Bb (B^T x) with B^T x one slot-local rank-k product and one
    psum (``woodbury.c:259-286``); the coarse LRC levels ride the
    replicated sub-sampler."""
    from parmgmc_tpu_torch.parallel.fused import _zeros, on_devices
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    op0 = sampler.ops[0]
    is_lrc = isinstance(op0, LRCOperator)
    base0 = op0.base if is_lrc else op0
    if not isinstance(base0, GraphOperator):
        raise ValueError("make_sharded_graph_mgmc_step shards graph (unstructured-mesh) hierarchies only; "
                         "structured samplers take parallel.mesh.shard_sampler or parallel.fused")
    if sampler.gamma != 1:
        raise ValueError("the sharded graph MGMC step runs V-cycles only (gamma = 1)")
    slots = _axis_slots(mesh, axis_name)
    spec = partition_graph_operator(base0, len(slots), coords=coords, ghost_mode=ghost_mode, devices=slots)
    s0 = sampler.smoothers[0]
    om, sweep, dt = s0.omega, s0.sweep, op0.dtype
    nf = noise_factor(om, dt)
    nsc = [nf * torch.sqrt(sl.diag) for sl in spec.slots]
    batch = (n_chains,) if n_chains else ()
    L = spec.n_local
    dirs = ["forward", "backward"] if sweep == "symmetric" else [sweep]

    if is_lrc:
        if not s0.is_lrc:
            raise ValueError("the level-0 smoother of an LRC hierarchy lacks its Woodbury factors")
        k_lr = op0.k
        B_l = rows_to_local(spec, op0.B)
        Bb_l = {d: rows_to_local(spec, s0.woodbury(d).dense) for d in dirs}
        sig = [op0.sigma_inv.to(d) for d in slots]
        sq_sig = [s0.sqrt_sigma_inv.to(d) for d in slots]

    sub = MGMCSampler(
        ops=sampler.ops[1:], transfers=sampler.transfers[1:], smoothers=sampler.smoothers[1:],
        coarse=sampler.coarse, n_pre=sampler.n_pre, n_post=sampler.n_post,
        n_levels=sampler.n_levels - 1, n_coarse=sampler.n_coarse, gamma=sampler.gamma,
    )
    subs = on_devices(sub, slots, canonical(sampler.device))

    # level-0 transfer in sharded form: P^T partials over owned rows, P
    # rows gathered from the replicated coarse vector
    tr = sampler.transfers[0]
    pt_vals, pt_cols = tr.pt_vals.cpu().numpy(), tr.pt_cols.cpu().numpy()
    p_vals, p_cols = tr.p_vals.cpu().numpy(), tr.p_cols.cpu().numpy()
    slot_of = np.zeros(op0.n, np.int64)
    owner = np.zeros(op0.n, np.int64)
    for s in range(spec.n_shards):
        gs = np.where(spec.own_mask[s] > 0)[0]
        slot_of[spec.own_gid[s, gs]] = gs
        owner[spec.own_gid[s, gs]] = s
    ptv, ptc, pv, pc = [], [], [], []
    for s, d in enumerate(slots):
        mine = owner[pt_cols] == s
        ptv.append(torch.as_tensor(np.where(mine, pt_vals, 0.0), device=d).to(dt))
        ptc.append(torch.as_tensor(np.where(mine, slot_of[pt_cols], 0), device=d))
        gs = np.where(spec.own_mask[s] > 0)[0]
        v = np.zeros((L, p_vals.shape[1]), p_vals.dtype)
        c = np.zeros((L, p_cols.shape[1]), np.int64)
        v[gs], c[gs] = p_vals[spec.own_gid[s, gs]], p_cols[spec.own_gid[s, gs]]
        pv.append(torch.as_tensor(v, device=d).to(dt))
        pc.append(torch.as_tensor(c, device=d))

    n_pre, n_post = sampler.n_pre, sampler.n_post

    def bt_x(xs):
        """B^T x on every slot: slot-local rank-k products and one psum."""
        return psum([torch.tensordot(B, x, dims=([0], [0])) for B, x in zip(B_l, xs)])

    def op_apply(xs):
        ax = sharded_apply(spec, xs)
        if not is_lrc:
            return ax
        return [a + torch.tensordot(B, bcast(si, t) * t, dims=([1], [0]))
                for a, B, si, t in zip(ax, B_l, sig, bt_x(xs))]

    def shared_draw(key, shape, device, cache):
        """One draw a distinct device from the shared stream ``key``."""
        if device not in cache:
            cache[device] = torch.randn(shape, generator=keys.generator(key, device), dtype=dt,
                                        device=device)
        return cache[device]

    def gibbs(kls, ksh, ys, rs, ctr):
        """One level-0 Gibbs step (GibbsSampler.step_with_noise: fresh
        noise a half-sweep)."""
        for i, d in enumerate(dirs):
            bt, cache = [], {}
            for t, (sl, r, ns) in enumerate(zip(spec.slots, rs, nsc)):
                if with_noise:
                    g = keys.generator(keys.fold_in(kls[t], 2 * ctr + i), sl.device)
                    eta = torch.randn((L,) + batch, generator=g, dtype=dt, device=sl.device)
                else:
                    eta = torch.zeros((L,) + batch, dtype=dt, device=sl.device)
                b = r + bcast(ns, eta) * eta
                if is_lrc:
                    eta2 = (shared_draw(keys.fold_in(ksh, 2 * ctr + i), (k_lr,) + batch, sl.device, cache)
                            if with_noise else torch.zeros((k_lr,) + batch, dtype=dt, device=sl.device))
                    b = b + torch.tensordot(B_l[t], bcast(sq_sig[t], eta2) * eta2, dims=([1], [0]))
                bt.append(b)
            ys = sharded_sor_sweep(spec, bt, ys, om, d)
            if is_lrc:
                ys = [y - torch.tensordot(Bb, t, dims=([1], [0]))
                      for y, Bb, t in zip(ys, Bb_l[d], bt_x(ys))]
        return ys

    def coarse_cycle(rcs, ksh):
        zs = {}
        for d, rc in zip(slots, rcs):
            if d in zs:
                continue
            smp = subs[d]
            if with_noise:
                zs[d] = smp._cycle_general(0, rc, ksh)
            else:
                zs[d] = smp._cycle(0, rc, _zeros(with_batch(smp.noise_shapes(), batch), dt, d))
        return [zs[d] for d in slots]

    def step(key: int, xs, bs):
        key, sk = keys.split(key)
        kls = [keys.fold_in(sk, t + 1) for t in range(len(slots))]  # per-slot level-0 streams
        ksh = keys.fold_in(sk, 0)  # the shared (replicated) stream
        rs = [bcast(b, a) - a for b, a in zip(_zeros_rhs(xs, bs), op_apply(xs))]  # b - A x
        ys = [torch.zeros_like(x) for x in xs]
        for i in range(n_pre):
            ys = gibbs(kls, ksh, ys, rs, i)
        # restricted residual: per-slot partial P^T plus one psum
        rr = [_mask_rows(r - a, sl.own_mask) for r, a, sl in zip(rs, op_apply(ys), spec.slots)]
        zs = coarse_cycle(psum([_ell(v, c, r) for v, c, r in zip(ptv, ptc, rr)]), ksh)
        ys = [y + _ell(v, c, z) for y, v, c, z in zip(ys, pv, pc, zs)]  # local prolong-add
        for i in range(n_post):
            ys = gibbs(kls, ksh, ys, rs, n_pre + i)
        return key, [x + y for x, y in zip(xs, ys)]

    return step, spec, GraphLayout(spec, op0.n)
