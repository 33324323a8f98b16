"""Multigrid Monte Carlo (MGMC) sampler (port of ``parmgmc_tpu.samplers.mgmc``).

A stochastic V/W-cycle whose level smoothers are Gibbs samplers (or the
samplers a registry config names) and whose coarsest level is an exact
Cholesky sample, driven as the chain

    x <- x + M_mg(b - A x).

Three routes through the same sampler:

* ``step_with_noise(x, b, noises)`` -- the general explicit-noise cycle
  (any n_pre/n_post/gamma/sweep), plain torch; the oracle side of the
  tests and the body of the explicit-noise chains.
* ``step(key, x, b)`` / ``step_deferred`` on a V(1,0) cycle of link-count
  FD levels in float32 under aggregation -- the chain kernels, routed as
  the JAX package routes its own: level 0 in one
  :func:`~parmgmc_tpu_torch.kernels.mg_sweep.fused_chain_down_fd` launch,
  or, for planes over ``kernels.rb_gibbs._PLANE_LIMIT`` points, in
  ``fused_chain_down_2d_staged`` (``step_deferred``) or
  ``fused_chain_down_2d`` (``step``); levels 1 .. L-2 in
  :func:`~parmgmc_tpu_torch.kernels.mg_tail.fused_tail_down` from the
  first level the JAX tail's shape rule admits, and one
  ``fused_zero_gibbs_restrict_fd`` launch for each level above it; the
  coarse Cholesky sample and the up-phase adds in plain torch.
* ``step(key, x, b)`` on every other cycle -- the general keyed cycle:
  each pre- and post-sweep is the level smoother's keyed ``step`` (one
  full-sweep kernel launch per half-sweep on 3D star levels with scalar
  off-diagonals, see
  :class:`~parmgmc_tpu_torch.samplers.gibbs.GibbsSampler`; levels whose
  planes pass ``_PLANE_LIMIT`` take the large-plane sweep kernels; other
  levels, such as the 27-point Galerkin ones, an explicit-noise sweep in
  plain torch), residuals, transfers and the coarse sample in plain torch,
  gamma coarse iterations per level.

On an LRC (posterior) operator A + B Sigma^{-1} B^T every level is LRC
(B_c = P^T B).  The V(1,0) chain keeps level 0 on the unchanged chain
kernel with rank-k corrections around it (:meth:`MGMCSampler._lrc_down`),
the levels below run the general keyed cycle (the tail kernels know only
the base stencil), and the coarsest level draws from the dense LRC
matrix.  The chain step is affine in its b stream, so
:func:`attach_chain_b_response` probes the kernel's response to each
column of B once at create time: the kernel then reads the static b
only, and the low-rank part of the right-hand side enters as window
corrections.

The chain kernels restrict by 2^d block sums, so they serve only levels
coarsened by :class:`AggregateTransfer` with even extents (the JAX
``_down_fused_eligible`` / ``_tail_fused_eligible`` rule); every other
hierarchy runs the general keyed cycle.

The hierarchy (:func:`build_hierarchy`) is the JAX package's.  The
default, ``coarsening="linear"``, takes :class:`GeometricTransfer` and
the exact Galerkin product P^T A P read off comb probes
(:func:`~parmgmc_tpu_torch.operators.stencil.galerkin_coarse_operator`,
then ``compress_stencil``): in 3D every level below the finest is a
27-point stencil with coefficient fields, swept by the plain-torch
8-colour SOR.  ``coarsening="aggregate"`` keeps link-count FD in closed
form on even extents (kappa2' = 2^d kappa2, hinv2' = 2^(d-1) hinv2) and
probes P^T A P under aggregation for odd extents and non-FD stencils.

A graph operator (an unstructured mesh) takes the smoothed-aggregation
hierarchy (:func:`~parmgmc_tpu_torch.operators.aggregation.
aggregation_hierarchy`, as the JAX package does) whatever the
``coarsening``; its levels run no kernel (no chain kernel takes a
:class:`~parmgmc_tpu_torch.operators.transfer.SparseTransfer` level), so
every step is the general keyed cycle in plain torch, and x may carry
the chain axis, ``(n, C)``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from dataclasses import dataclass

import torch

from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.operators.aggregation import aggregation_hierarchy
from parmgmc_tpu_torch.operators.graph import GraphOperator, bcast
from parmgmc_tpu_torch.operators.lrc import (
    LRCOperator,
    column_patches,
    fused_patch_apply_add_,
    nonzero_bounds,
    patch_apply_add_,
    window,
    with_patches,
)
from parmgmc_tpu_torch.operators.stencil import (
    FDStencilOperator,
    StencilOperator,
    coarse_shape,
    compress_stencil,
    detect_fd_params,
    fd_stencil,
    galerkin_coarse_operator,
)
from parmgmc_tpu_torch.operators.transfer import AggregateTransfer, GeometricTransfer
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers import gibbs
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler

__all__ = ["MGMCSampler", "attach_chain_b_response", "build_hierarchy", "compute_lrc_aux"]


def build_hierarchy(op, n_levels=None, coarsest_size=128, coarsening="linear"):
    """(ops, transfers): per-level operators by Galerkin coarsening, grids
    halving (to ceil(n/2)) until fewer than ``coarsest_size`` points would
    remain; a graph operator takes the smoothed-aggregation hierarchy.

    ``coarsening="linear"`` (the default, as in JAX): GeometricTransfer
    and the comb-probed P^T A P, compressed.  ``"aggregate"``:
    AggregateTransfer; link-count FD levels of even extents coarsen in
    closed form, the others (odd extents, non-FD stencils) by the probe.
    On an LRC operator the base is coarsened so and each column of B
    restricted, B_c = P^T B, every level keeping the patch view of its
    localized columns."""
    if coarsening not in ("linear", "aggregate"):
        raise ValueError(f"unknown coarsening {coarsening!r} (linear or aggregate)")
    is_lrc = isinstance(op, LRCOperator)
    base0 = op.base if is_lrc else op
    if isinstance(base0, GraphOperator):
        return aggregation_hierarchy(op, n_levels=n_levels, coarsest_size=coarsest_size)
    if not isinstance(base0, StencilOperator):
        raise TypeError(f"MGMC needs a stencil or graph operator, got {type(base0).__name__}")
    ops, transfers = [op], []
    while True:
        cur = ops[-1].base if is_lrc else ops[-1]
        gshape = tuple(cur.grid_shape)
        if n_levels is not None and len(ops) >= n_levels:
            break
        if n_levels is None and math.prod(coarse_shape(gshape)) < coarsest_size:
            break
        if any(s <= 2 for s in gshape):
            break
        if coarsening == "aggregate":
            tr = AggregateTransfer(fine_shape=gshape)
            fd = detect_fd_params(cur) if all(s % 2 == 0 for s in gshape) else None
        else:
            tr, fd = GeometricTransfer(fine_shape=gshape), None
        if fd is not None:
            d = len(gshape)
            coarse = fd_stencil(
                coarse_shape(gshape),
                (2**d) * fd[0],
                (2 ** (d - 1)) * fd[1],
                dtype=cur.dtype,
                device=cur.device,
                lazy=True if isinstance(cur, FDStencilOperator) else "auto",
            )
        else:
            coarse = compress_stencil(galerkin_coarse_operator(cur, tr))
        transfers.append(tr)
        if is_lrc:
            B = ops[-1].B
            Bc = torch.stack([tr.restrict(B[..., j]) for j in range(B.shape[-1])], dim=-1)
            coarse = with_patches(LRCOperator(base=coarse, B=Bc, sigma_inv=ops[-1].sigma_inv))
        ops.append(coarse)
    return ops, tuple(transfers)


def compute_lrc_aux(ops, transfers, smoothers):
    """The rank-k matrices that keep the level-0 chain kernel on an LRC
    fine operator, or None when its smoother does not run it:

        RABb = R (A_base Bb)   (coarse grid, k)
        H    = B^T Bb          (k, k)
        Bb_colsum              (k,)   the column sums of Bb

    with Bb the level-0 smoother's Woodbury factor of its sweep direction
    (the deferred chain recovers the correction's part of each sample's
    sum from Bb_colsum)."""
    s0 = smoothers[0] if smoothers else None
    if not (
        isinstance(s0, GibbsSampler) and s0.is_lrc and s0.fd_params is not None and s0.has_kernel
        and s0.sweep in ("forward", "backward") and len(transfers) >= 1
    ):
        return None
    base0 = ops[0].base
    Bb = s0.Bb_fw if s0.sweep == "forward" else s0.Bb_bw
    grid = list(range(base0.ndim))
    # one column at a time: no (k, *grid) temporaries at the fine size
    RABb = torch.stack(
        [transfers[0].restrict(base0.apply(Bb[..., j])) for j in range(Bb.shape[-1])], dim=-1
    )
    H = torch.tensordot(ops[0].B, Bb, dims=(grid, grid))
    return {"RABb": RABb, "H": H, "Bb_colsum": Bb.sum(dim=grid)}


def _pack(wins, shape, fill):
    """(vals (k, *ext), starts) of k windows [(values, lows)] padded to one
    extent and clamped into ``shape``, or None past ``fill`` of it."""
    d = len(shape)
    ext = [max(w.shape[ax] for w, _ in wins) for ax in range(d)]
    if math.prod(ext) * len(wins) > fill * math.prod(shape):
        return None
    vals = wins[0][0].new_zeros((len(wins), *ext))
    starts = []
    for j, (w, los) in enumerate(wins):
        st = tuple(min(los[ax], shape[ax] - ext[ax]) for ax in range(d))
        vals[(j, *window([lo - s for lo, s in zip(los, st)], w.shape))] = w
        starts.append(st)
    return vals, tuple(starts)


def _union_pack(sets, shape):
    """(vals (m, k, *ext), starts): m factor sets [(vals (k, *box_i),
    starts_i)] on per-column union windows, so that one update a window
    applies every set (zero padding is exact: every factor has exact
    compact support)."""
    d = len(shape)
    k = sets[0][0].shape[0]
    los = [[min(st[j][a] for _, st in sets) for a in range(d)] for j in range(k)]
    his = [[max(st[j][a] + v.shape[1 + a] for v, st in sets) for a in range(d)] for j in range(k)]
    ext = [max(his[j][a] - los[j][a] for j in range(k)) for a in range(d)]
    vals = sets[0][0].new_zeros((len(sets), k, *ext))
    starts = []
    for j in range(k):
        st = tuple(min(los[j][a], shape[a] - ext[a]) for a in range(d))
        starts.append(st)
        for i, (v, sti) in enumerate(sets):
            off = [sti[j][a] - st[a] for a in range(d)]
            vals[(i, j, *window(off, v.shape[1:]))] = v[j]
    return vals, tuple(starts)


def attach_chain_b_response(smp, max_fill: float = 0.5):
    """``smp`` with the level-0 chain kernel's response to each column of
    B attached to its ``lrc_aux``, or ``smp`` itself when the posterior
    chain does not run the kernel or B has no patch view.

    The chain step is affine in its b stream, so the posterior's
    b_eff = b + B wv never needs to be formed: the kernel runs on the
    static b and the low-rank part is added after it,

        xpy(b + B wv) = xpy(b) + Mb wv,    rc(b + B wv) = rc(b) + RB wv,

    with Mb[:, j], RB[:, j] the kernel's own responses to column j: two
    calls under the same key (x = 0 and b = 0, then b = s_j B_j) differ
    only where B_j reaches, so the difference over s_j has exact compact
    support and is kept as windows (Mb_pv/Mb_ps, RB_pv/RB_ps), with
    BtMb = B^T Mb and the column sums of Mb.  The factor sets that share
    a window are packed once more on per-column union windows: the coarse
    set [R A Bb, RB, B_c] as CW_pv/CW_ps and the fine set [Mb, Bb] as
    FW_pv/FW_ps, where every factor has a patch view.

    A kernel failure raises.  A response with no support raises (the
    kernel would ignore its b stream); so does a column of B that is zero
    everywhere.  Responses too wide for ``max_fill`` of the fine grid
    keep the b_eff route with a warning."""
    op0 = smp.ops[0]
    if (
        smp.lrc_aux is None
        or "Mb_pv" in smp.lrc_aux
        or not isinstance(op0, LRCOperator)
        or not smp._lrc_chain_eligible()
        or op0.patch_vals is None
    ):
        return smp
    gshape = tuple(smp.grid_shape)
    d = len(gshape)
    x0 = torch.zeros(gshape, dtype=op0.dtype, device=op0.device)
    xpy0, rc0, _ = smp._fused_chain_down(x0, x0, 0)
    cshape = tuple(rc0.shape)
    fine, coarse, btmb, colsum = [], [], [], []
    for j in range(op0.k):
        col = op0.B[..., j]
        peak = float(col.abs().max())
        if peak == 0.0:
            raise ValueError(f"column {j} of B is zero everywhere: it observes nothing")
        s_j = 1e6 / peak
        xpyj, rcj, _ = smp._fused_chain_down(x0, (col * s_j).contiguous(), 0)
        dm, dr = (xpyj - xpy0) / s_j, (rcj - rc0) / s_j
        bm, br = nonzero_bounds(dm), nonzero_bounds(dr)
        if bm is None or br is None:
            raise RuntimeError(f"the chain kernel shows no response to column {j} of its b stream")
        btmb.append(op0.bt_apply(dm))
        colsum.append(dm.sum())
        fine.append((dm[tuple(slice(lo, hi) for lo, hi in bm)], [lo for lo, _ in bm]))
        coarse.append((dr[tuple(slice(lo, hi) for lo, hi in br)], [lo for lo, _ in br]))
    # coarse windows are 8x smaller than the fine grid even when they cover
    # their whole level, so they are always taken
    pf, pc = _pack(fine, gshape, max_fill), _pack(coarse, cshape, d + 8.0)
    if pf is None or pc is None:
        warnings.warn(
            "the chain kernel's responses to B cover more than "
            f"{max_fill:g} of the grid: the posterior chain keeps the b_eff route",
            RuntimeWarning, stacklevel=2,
        )
        return smp
    aux = dict(smp.lrc_aux)
    aux.update(
        Mb_pv=pf[0], Mb_ps=pf[1], RB_pv=pc[0], RB_ps=pc[1],
        BtMb=torch.stack(btmb, dim=1), Mb_colsum=torch.stack(colsum),
    )
    opc = smp.ops[1]
    rabb = column_patches(aux["RABb"], max_fill=d + 8.0)
    s0 = smp.smoothers[0]
    bb = s0.Bb_fw_patches if s0.sweep == "forward" else s0.Bb_bw_patches
    if rabb is not None and opc.patch_vals is not None:
        aux["CW_pv"], aux["CW_ps"] = _union_pack([rabb, pc, (opc.patch_vals, opc.patch_starts)], cshape)
    if bb is not None:
        aux["FW_pv"], aux["FW_ps"] = _union_pack([pf, bb], gshape)
    return dataclasses.replace(smp, lrc_aux=aux)


@dataclass(frozen=True, eq=False)
class MGMCSampler:
    """Stochastic V/W(n_pre, n_post)-cycle chain sampler for N(A^{-1}b, A^{-1}).

    ``lrc_aux`` holds the rank-k matrices of the LRC chain step
    (:func:`compute_lrc_aux`, :func:`attach_chain_b_response`); None on a
    prior."""

    ops: tuple
    transfers: tuple
    smoothers: tuple
    coarse: object
    n_pre: int
    n_post: int
    n_levels: int
    n_coarse: int = 1
    gamma: int = 1
    lrc_aux: "dict | None" = None

    @staticmethod
    def create(
        op,
        n_levels=None,
        coarsest_size: int = 128,
        omega: float = 1.0,
        sweep: str = "forward",
        n_pre: int = 1,
        n_post: int = 1,
        coarse_sampler=None,
        n_coarse: int = 1,
        coarsening: str = "linear",
        gamma: int = 1,
    ) -> "MGMCSampler":
        ops, transfers = build_hierarchy(
            op, n_levels=n_levels, coarsest_size=coarsest_size, coarsening=coarsening
        )
        return MGMCSampler.from_levels(
            ops, transfers, coarse_sampler or CholeskySampler.create(ops[-1]),
            omega=omega, sweep=sweep, n_pre=n_pre, n_post=n_post,
            n_coarse=n_coarse, gamma=gamma,
        )

    @staticmethod
    def from_levels(ops, transfers, coarse, omega=1.0, sweep="forward", n_pre=1,
                    n_post=1, n_coarse=1, gamma=1, smoothers=None) -> "MGMCSampler":
        """The sampler over built levels; on an LRC hierarchy with the
        rank-k matrices of its chain step (probing the chain kernel).  The
        level smoothers are ``GibbsSampler(omega, sweep)`` unless
        ``smoothers`` gives one sampler a level above the coarsest (the
        registry's per-level configs)."""
        if smoothers is None:
            smoothers = tuple(GibbsSampler.create(o, omega=omega, sweep=sweep) for o in ops[:-1])
        smoothers = tuple(smoothers)
        if len(smoothers) != len(ops) - 1:
            raise ValueError(f"{len(smoothers)} smoothers for {len(ops) - 1} smoothed levels")
        smp = MGMCSampler(
            ops=tuple(ops), transfers=tuple(transfers), smoothers=smoothers,
            coarse=coarse, n_pre=n_pre, n_post=n_post, n_levels=len(ops),
            n_coarse=n_coarse, gamma=gamma,
            lrc_aux=compute_lrc_aux(ops, transfers, smoothers),
        )
        return attach_chain_b_response(smp)

    @property
    def fine_op(self):
        return self.ops[0]

    @property
    def grid_shape(self):
        return self.fine_op.grid_shape

    @property
    def dtype(self):
        return self.fine_op.dtype

    @property
    def device(self):
        return self.fine_op.device

    # -- explicit-noise cycle (general) --------------------------------------
    def noise_shapes(self):
        def level(l):
            if l == self.n_levels - 1:
                return [self.coarse.noise_shapes() for _ in range(self.n_coarse)]
            s = self.smoothers[l]
            return {
                "pre": [s.noise_shapes() for _ in range(self.n_pre)],
                "sub": [level(l + 1) for _ in range(self.gamma)],
                "post": [s.noise_shapes() for _ in range(self.n_post)],
            }

        return level(0)

    def _cycle(self, l: int, bl, noises):
        """One stochastic V-cycle at level l from a zero initial guess."""
        if l == self.n_levels - 1:
            x = torch.zeros_like(bl)
            for i in range(self.n_coarse):
                x = self.coarse.step_with_noise(x, bl, noises[i])
            return x
        op = self.ops[l]
        smoother = self.smoothers[l]
        x = torch.zeros_like(bl)
        for i in range(self.n_pre):
            x = smoother.step_with_noise(x, bl, noises["pre"][i])
        r = self.transfers[l].restrict(bl - op.apply(x))
        xc = self._cycle(l + 1, r, noises["sub"][0])
        for g in range(1, self.gamma):  # W-cycle: iterate the coarse chain
            rc = r - self.ops[l + 1].apply(xc)
            xc = xc + self._cycle(l + 1, rc, noises["sub"][g])
        x = x + self.transfers[l].prolong(xc)
        for i in range(self.n_post):
            x = smoother.step_with_noise(x, bl, noises["post"][i])
        return x

    def step_with_noise(self, x, b, noises):
        """x <- x + M_mg(b - A x) with explicit N(0,1) draws; ``b=None``
        is a zero RHS.  ``x`` may carry trailing chain dims (the noises
        then carry them too): graph levels take them chain-major, stencil
        levels one chain at a time."""
        if x.ndim > len(self.grid_shape) and not self._graph():
            return gibbs.per_chain(self.step_with_noise, x, b, noises, len(self.grid_shape))
        if b is None:
            b = torch.zeros_like(x)
        return x + self._cycle(0, bcast(b, x) - self.fine_op.apply(x), noises)

    def _graph(self) -> bool:
        """Are the levels graph operators (an unstructured mesh)?"""
        op0 = self.fine_op
        return isinstance(op0.base if isinstance(op0, LRCOperator) else op0, GraphOperator)

    @property
    def has_kernel(self) -> bool:
        """Does the keyed step run a kernel: the chain kernels, or a
        smoother's or the coarse sampler's?"""
        return self.deferred_eligible() or any(
            getattr(s, "has_kernel", False) for s in (*self.smoothers, self.coarse))

    def prepare(self, b):
        return None

    # -- keyed cycle on the kernels -------------------------------------------
    def _block_level(self, l: int) -> bool:
        """Can a chain kernel serve level l?  Its smoother is a Gibbs
        sampler and the level coarsens by 2^d block sums: an
        AggregateTransfer of even extents (the restriction the kernels
        fuse; JAX ``_down_fused_eligible`` and ``_tail_fused_eligible``)."""
        return (
            isinstance(self.smoothers[l], GibbsSampler)
            and isinstance(self.transfers[l], AggregateTransfer)
            and all(n % 2 == 0 for n in self.ops[l].grid_shape)
        )

    def deferred_eligible(self) -> bool:
        """Does the keyed step run the V(1,0) chain kernels (and so admit
        the deferred chain)?  One forward or backward pre-sweep, no
        post-sweep, gamma = 1, a 3D grid, every smoothed level link-count
        FD in float32 and coarsened by aggregation with even extents (the
        JAX ``_down_fused_eligible`` / ``deferred_eligible`` shape, without
        the Mosaic gates).  On an LRC operator only level 0 runs a chain
        kernel, and the rank-k matrices must be there
        (:meth:`_lrc_chain_eligible`)."""
        if self.n_pre != 1 or self.n_post != 0 or self.gamma != 1:
            return False
        if self.n_levels < 2 or len(self.grid_shape) != 3:
            return False
        if not self._block_level(0):
            return False
        s0 = self.smoothers[0]
        if s0.sweep not in ("forward", "backward") or not s0.has_kernel:
            return False
        if s0.is_lrc:
            return self.lrc_aux is not None
        return all(
            self._block_level(l) and self.smoothers[l].sweep == s0.sweep
            and self.smoothers[l].fd_params is not None and self.smoothers[l].has_kernel
            for l in range(self.n_levels - 1)
        )

    def _lrc_chain_eligible(self) -> bool:
        """Does the keyed step run level 0 of an LRC operator on the chain
        kernel (with :meth:`_lrc_down`'s rank-k corrections)?"""
        return self.deferred_eligible() and self.smoothers[0].is_lrc

    def _chain_level0_2d(self) -> bool:
        """Does level 0 take the large-plane chain kernels?  A 3D grid the
        marching kernel takes whose plane is above
        ``kernels.rb_gibbs._PLANE_LIMIT`` points (the JAX
        ``_chain_level0_2d`` without its VMEM probe).  It depends on the
        shape alone, so step and step_deferred agree."""
        from parmgmc_tpu_torch.kernels.mg_sweep import chain_down_2d_supported
        from parmgmc_tpu_torch.kernels.rb_gibbs import _PLANE_LIMIT

        gs = self.grid_shape
        return chain_down_2d_supported(gs) and gs[1] * gs[2] > _PLANE_LIMIT

    def _fused_chain_down(self, x, b, key, z=None, with_xsum=False, with_zsum=False):
        """(xpy, rc, key, *partials): the level-0 chain kernel -- #1 up to
        ``_PLANE_LIMIT`` points a plane; above it the staged kernel when
        the deferred carry ``z`` is given (step_deferred), the windowed
        one when not (step).  This is the ONLY place its seed and step are
        derived from the key -- step and step_deferred both come through
        here, which keeps their sample sequences bit-identical (the three
        kernels compute the same function with the same draws)."""
        from parmgmc_tpu_torch.kernels import mg_sweep

        if not self._chain_level0_2d():
            fn = mg_sweep.fused_chain_down_fd
        elif z is not None:
            fn = mg_sweep.fused_chain_down_2d_staged
        else:
            fn = mg_sweep.fused_chain_down_2d
        s = self.smoothers[0]
        key, k1, k2 = keys.split(key, 3)
        out = fn(
            x, b, s._coeff6(), s.fd_params[0], s.fd_params[1], s.omega,
            keys.randint31(k1), keys.randint31(k2), sweep=s.sweep, z=z,
            with_xsum=with_xsum, with_zsum=with_zsum,
        )
        return (out[0], out[1], key, *out[2:])

    def _fused_down(self, l: int, bl, key):
        """(y, rc, key): level l's down-phase from zero in one
        ``fused_zero_gibbs_restrict_fd`` launch."""
        from parmgmc_tpu_torch.kernels.mg_sweep import fused_zero_gibbs_restrict_fd

        s = self.smoothers[l]
        key, k1, k2 = keys.split(key, 3)
        y, rc = fused_zero_gibbs_restrict_fd(
            bl, s._coeff6(), s.fd_params[0], s.fd_params[1], s.omega,
            keys.randint31(k1), keys.randint31(k2), sweep=s.sweep,
        )
        return y, rc, key

    def _tail_fused_eligible(self, l: int) -> bool:
        """Do levels l .. L-2 run on the tail kernel?  The JAX
        ``_tail_fused_eligible`` shape rule (1 <= l <= L-2, level l's n2
        divides 128, n0 n1 128 <= 128^3 at level l; the cycle and level
        checks are :meth:`deferred_eligible`'s).  Here it only picks
        between two ported kernels: levels it refuses take
        :meth:`_fused_down`.  The rule is the TPU kernel's lane and
        compile-volume gate, not measured on the H100 (ROADMAP.md slice
        2c)."""
        if l < 1 or l > self.n_levels - 2:
            return False
        if not all(self._block_level(m) for m in range(l, self.n_levels - 1)):
            return False
        if self.smoothers[l].is_lrc:
            return False
        n0, n1, n2 = self.ops[l].grid_shape
        return n2 <= 128 and 128 % n2 == 0 and n0 * n1 * 128 <= 128**3

    def _fused_tail_cycle(self, l: int, bl, key):
        """One keyed cycle over levels l .. coarsest: the smoothed levels'
        down-phases in the tail kernel, the coarse sample and the up-phase
        adds z_m = y_m + P z_{m+1} in plain torch."""
        from parmgmc_tpu_torch.kernels.mg_tail import fused_tail_down

        shapes = tuple(tuple(self.ops[m].grid_shape) for m in range(l, self.n_levels))
        params = []
        for m in range(l, self.n_levels - 1):
            s = self.smoothers[m]
            params += [s.omega, s.fd_params[0], s.fd_params[1]]
        key, k1, k2 = keys.split(key, 3)
        color0 = 0 if self.smoothers[l].sweep == "forward" else 1
        ys, rhs = fused_tail_down(
            bl, params, keys.randint31(k1), keys.randint31(k2), color0, shapes
        )
        x = torch.zeros_like(rhs)
        for _ in range(self.n_coarse):
            key, x = self.coarse.step(key, x, rhs)
        for m in reversed(range(len(shapes) - 1)):
            x = self.transfers[l + m].prolong_add(ys[m], x)
        return x

    def _cycle_general(self, l: int, bl, key):
        """Keyed cycle from zero at level l through the smoothers' keyed
        steps (``parmgmc_tpu`` ``_cycle_keyed``, general branch)."""
        if l == self.n_levels - 1:
            return self._cycle_keyed(l, bl, key)  # the coarse sample
        op = self.ops[l]
        smoother = self.smoothers[l]
        x = torch.zeros_like(bl)
        for _ in range(self.n_pre):
            key, x = smoother.step(key, x, bl)
        key, sub = keys.split(key)
        r = self.transfers[l].restrict(bl - op.apply(x))
        xc = self._cycle_general(l + 1, r, sub)
        for _ in range(1, self.gamma):  # W-cycle: iterate the coarse chain
            key, sub = keys.split(key)
            rc = r - self.ops[l + 1].apply(xc)
            xc = xc + self._cycle_general(l + 1, rc, sub)
        x = self.transfers[l].prolong_add(x, xc)
        for _ in range(self.n_post):
            key, x = smoother.step(key, x, bl)
        return x

    def _cycle_keyed(self, l: int, bl, key):
        """Keyed V(1,0) cycle from zero at level l (kernels throughout;
        only where :meth:`deferred_eligible`).  LRC levels run the general
        keyed cycle: the from-zero kernels know only the base stencil."""
        if l == self.n_levels - 1:
            x = torch.zeros_like(bl)
            for _ in range(self.n_coarse):
                key, x = self.coarse.step(key, x, bl)
            return x
        if self.smoothers[l].is_lrc:
            return self._cycle_general(l, bl, key)
        if self._tail_fused_eligible(l):
            return self._fused_tail_cycle(l, bl, key)
        # any other level from zero, level 0 too (fmg_init)
        y, rc, key = self._fused_down(l, bl, key)
        key, sub = keys.split(key)
        return self.transfers[l].prolong_add(y, self._cycle_keyed(l + 1, rc, sub))

    def step(self, key: int, x, b, aux=None):
        """(key, x'): one keyed chain step.  ``b=None`` declares a zero RHS:
        the chain kernel then reads no b at all, the general cycle
        substitutes zeros for the fine residual.  ``x`` may carry trailing
        chain dims on the plain route (a graph hierarchy runs them
        chain-major through the general keyed cycle, a stencil one takes
        the explicit-noise step with every draw carrying them, as the JAX
        package's keyed step does); a kernel sampler refuses them."""
        batch = x.shape[len(self.grid_shape):]
        if batch:
            if self.has_kernel:
                gibbs.refuse_batch(self, batch)
            if not self._graph():
                key, sub = keys.split(key)
                shapes = gibbs.with_batch(self.noise_shapes(), batch)
                return key, self.step_with_noise(x, b, gibbs._draw(sub, shapes, x.dtype, x.device))
        key, sub = keys.split(key)
        if not self.deferred_eligible():
            bz = torch.zeros_like(x) if b is None else bcast(b, x)
            return key, x + self._cycle_general(0, bz - self.fine_op.apply(x), sub)
        if self.smoothers[0].is_lrc:
            xpy, rc, sub, *_ = self._lrc_down(sub, x, b)
        else:
            xpy, rc, sub = self._fused_chain_down(x, b, sub)
        sub, sub2 = keys.split(sub)
        z1 = self._cycle_keyed(1, rc, sub2)
        return key, self.transfers[0].prolong_add(xpy, z1)

    def _lrc_down(self, sub: int, x, b, z=None, btx=None):
        """(x_out, rc, sub, btx_next, sx, zsum): level 0's down-phase on an
        LRC fine operator -- the unchanged chain kernel with rank-k
        corrections around it, in plain torch on the device.

        With w = sqrt(Sigma^{-1}) eta_lr (k draws) and wv = w - Sigma^{-1}
        B^T x, the kernel run on b_eff = b + B wv performs the smoother's
        sweep with its low-rank noise and the low-rank part of the chain's
        residual.  Then, with c = B^T y (y the kernel's sweep),

            x_out = xpy - Bb c                       (the Woodbury correction)
            rc    = rc_kernel + R(A Bb) c - B_c (w + Sigma^{-1}(c - H c))

        remove what the kernel's restricted residual has that the true
        one has not (the noise B w, the correction it did not see, the
        low-rank part of the smoothed residual).  On the probed route
        (``Mb_pv`` in ``lrc_aux``) the kernel reads the static b and
        b_eff's low-rank part enters as the responses Mb wv and RB wv.

        ``z`` (the deferred carry, x = xpy + P z) and ``btx`` (B^T of the
        kernel's x when known) come from :meth:`step_deferred`, which also
        takes ``btx_next`` (B^T x_out on the probed route, else None), the
        sum of x_out ``sx`` and the kernel's ``zsum`` partials."""
        s = self.smoothers[0]
        op0, aux = self.fine_op, self.lrc_aux
        sub, klr = keys.split(sub)
        w = gibbs._lowrank_draw(klr, s.sqrt_sigma_inv, 1)[0]
        if btx is None:
            btx = op0.bt_apply(x)
        if z is not None:
            btx = btx + self._bt_carry(z)
        wv = w - op0.sigma_inv * btx
        H = aux["H"]
        sums = z is not None
        probed = "Mb_pv" in aux
        b_eff = b if probed else (op0.b_apply(wv) if b is None else op0.b_apply_add(wv, b))
        xpy, rc, sub, *partials = self._fused_chain_down(
            x, b_eff, sub, z=z, with_xsum=sums, with_zsum=sums
        )
        u = op0.bt_apply(xpy)
        c = u - btx
        if probed:
            c = c + aux["BtMb"] @ wv
        cc = w + op0.sigma_inv * (c - H @ c)
        if "CW_pv" in aux:
            fused_patch_apply_add_(aux["CW_pv"], aux["CW_ps"], torch.stack([c, wv, -cc]), rc)
        else:
            if probed:
                patch_apply_add_(aux["RB_pv"], aux["RB_ps"], wv, rc)
            rc = self.ops[1].b_apply_add_(-cc, rc.add_(aux["RABb"] @ c))
        if "FW_pv" in aux:
            fused_patch_apply_add_(aux["FW_pv"], aux["FW_ps"], torch.stack([wv, -c]), xpy)
        else:
            if probed:
                patch_apply_add_(aux["Mb_pv"], aux["Mb_ps"], wv, xpy)
            s._bb_apply_sub_(s.sweep, xpy, c)
        btx_next = sx = zsum = None
        if probed:  # B^T(xpy + Mb wv - Bb c), by identity
            btx_next = u + aux["BtMb"] @ wv - H @ c
        if sums:
            xsum, zsum = partials
            sx = xsum.sum() - aux["Bb_colsum"] @ c
            if probed:
                sx = sx + aux["Mb_colsum"] @ wv
        return xpy, rc, sub, btx_next, sx, zsum

    # -- deferred-prolong chain (lazy fine state) ------------------------------
    def _bt_carry(self, z):
        """B^T (P0 z) of a compact carry: B_c^T z with B_c = P^T B, the
        hierarchy's restricted columns (their windows, when patched)."""
        return self.ops[1].bt_apply(z)

    def deferred_init(self, dtype, x=None):
        """Zero compact carry z (N0/2, N1/2, N2/2): the lazy state is the
        pair (xpy, z) standing for x = xpy + P0 z.  On the probed
        posterior route the carry is the pair (z, B^T x) for the chain's
        starting state ``x`` (zero when omitted): each step then takes the
        next B^T x from an identity instead of reading the k windows."""
        z = torch.zeros(coarse_shape(self.grid_shape), dtype=dtype, device=self.device)
        if self.lrc_aux is None or "Mb_pv" not in self.lrc_aux:
            return z
        if x is None:
            return z, torch.zeros(self.fine_op.k, dtype=dtype, device=self.device)
        return z, self.fine_op.bt_apply(x).to(dtype)

    def step_deferred(self, key: int, xpy, z, b):
        """(key, xpy', z', sum_xpy', zprev_sum): lazy chain step.

        The prolong-add x = xpy + P0 z of the previous step happens inside
        this step's chain kernel, so x is never written.  Bit-identical
        samples to :meth:`step` under the same key on a prior (the kernel
        performs the same adds); on a posterior the same samples up to the
        summation order of the rank-k terms.  ``sum_xpy'`` is the sum of
        xpy' (from the kernel's partial sums); ``zprev_sum`` = sum(P0 z) of
        the carry it consumed, i.e. the rest of the PREVIOUS sample's sum.
        ``z`` is the pair of :meth:`deferred_init` on the probed
        posterior route, and so is ``z'``."""
        if not self.deferred_eligible():
            raise NotImplementedError(
                "the deferred chain runs the V(1,0) chain kernels only (one "
                "forward/backward pre-sweep, no post-sweep, gamma = 1, FD float32 "
                "levels under aggregation with even extents), as the JAX "
                "deferred_eligible; use sample_chain"
            )
        gibbs.refuse_batch(self, xpy.shape[len(self.grid_shape):])
        pair = isinstance(z, tuple)
        z, btx = z if pair else (z, None)
        key, sub = keys.split(key)
        if self.smoothers[0].is_lrc:
            xpy2, rc, sub, btx, sx, zsum = self._lrc_down(sub, xpy, b, z=z, btx=btx)
        else:
            xpy2, rc, sub, xsum, zsum = self._fused_chain_down(
                xpy, b, sub, z=z, with_xsum=True, with_zsum=True
            )
            sx = xsum.sum()
        sub, sub2 = keys.split(sub)
        zn = self._cycle_keyed(1, rc, sub2)
        return key, xpy2, ((zn, btx) if pair else zn), sx, 8.0 * zsum.sum()

    def deferred_final_sum(self, z):
        """sum(P0 z) for a compact carry: each coarse cell covers 8 fine."""
        if isinstance(z, tuple):
            z = z[0]
        return 8.0 * z.sum()

    def materialize_deferred(self, xpy, z):
        """The sample the lazy pair represents: xpy + P0 z."""
        if isinstance(z, tuple):
            z = z[0]
        return self.transfers[0].prolong_add(xpy, z)

    def fmg_init(self, key: int, b, n_cycles: int = 1):
        """(key, x0): full-multigrid cold start -- an exact coarsest draw,
        prolonged and refined by ``n_cycles`` keyed cycles per level, so
        chains started from it need almost no burn-in."""
        bs = [torch.zeros(self.grid_shape, dtype=self.dtype, device=self.device)
              if b is None else b]
        for l in range(self.n_levels - 1):
            bs.append(self.transfers[l].restrict(bs[-1]))
        x = torch.zeros_like(bs[-1])
        for _ in range(max(self.n_coarse, 1)):
            key, x = self.coarse.step(key, x, bs[-1])
        cycle = self._cycle_keyed if self.deferred_eligible() else self._cycle_general
        for l in reversed(range(self.n_levels - 1)):
            x = self.transfers[l].prolong(x)
            for _ in range(n_cycles):
                key, sub = keys.split(key)
                r = bs[l] - self.ops[l].apply(x)
                x = x + cycle(l, r, sub)
        return key, x
