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
  each pre- and post-sweep is the level smoother's keyed step (one
  full-sweep kernel call per half-sweep on 3D star levels with scalar
  off-diagonals and on the 27-point Galerkin levels, see
  :class:`~parmgmc_tpu_torch.samplers.gibbs.GibbsSampler`; levels whose
  planes pass ``_PLANE_LIMIT`` take the large-plane sweep kernels; other
  levels an explicit-noise sweep in plain torch), each residual with its
  restriction in one launch of
  :func:`~parmgmc_tpu_torch.kernels.residual_restrict.residual_restrict`
  on 3D float32 stencil levels under the linear transfer (plain torch
  elsewhere), the prolongations and the coarse sample in plain torch,
  gamma coarse iterations per level.

The keyed step derives every integer it hands the device (each launch's
seed and step, each generator's seed) from its key in
:meth:`MGMCSampler.keyed_words`, before any device work, and runs on them
through a cursor (:class:`~parmgmc_tpu_torch.keys.Cursor`): ``step``,
``step_deferred`` and a step replayed from a captured CUDA graph
(:mod:`parmgmc_tpu_torch.replay`) take their draws from that one
derivation.  A step whose words hold a key for the host (a smoother or
coarse sampler outside this scheme, the plain route's draws) runs
eagerly.

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
27-point stencil with coefficient fields, swept 8 colours a call by
:func:`~parmgmc_tpu_torch.kernels.galerkin_sweep.fused_galerkin_sweep` in
float32 (the plain-torch 8-colour SOR otherwise).
``coarsening="aggregate"`` keeps link-count FD in closed form on even
extents (kappa2' = 2^d kappa2, hinv2' = 2^(d-1) hinv2) and probes P^T A P
under aggregation for odd extents and non-FD stencils.

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

from parmgmc_tpu_torch import kernels, keys
from parmgmc_tpu_torch.kernels import residual_restrict
from parmgmc_tpu_torch.kernels._noise import CHAIN_DOMAIN, TAIL_DOMAIN
from parmgmc_tpu_torch.operators.aggregation import aggregation_hierarchy
from parmgmc_tpu_torch.operators.graph import GraphOperator, bcast
from parmgmc_tpu_torch.operators.lrc import (
    ColumnUnion,
    Columns,
    LRCOperator,
    nonzero_bounds,
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
from parmgmc_tpu_torch.profiling import span
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
    restricted, B_c = P^T B, every level keeping the window view of its
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
            coarse = with_patches(ops[-1].coarsened(coarse, tr))
        ops.append(coarse)
    return ops, tuple(transfers)


@dataclass(frozen=True, eq=False)
class ChainProbe:
    """The level-0 chain kernel's responses to the columns of B
    (:func:`attach_chain_b_response`): ``Mb`` on the fine grid and ``RB``
    on the coarse one, kept as windows only, with ``BtMb`` = B^T Mb
    (k, k) and ``Mb_colsum`` (k,); and the stacks the chain step updates
    together, ``coarse`` = [R A Bb, RB, B_c] and ``fine`` = [Mb, Bb]."""

    Mb: Columns
    RB: Columns
    BtMb: torch.Tensor
    Mb_colsum: torch.Tensor
    coarse: ColumnUnion
    fine: ColumnUnion


@dataclass(frozen=True, eq=False)
class LRCAux:
    """The rank-k matrices that keep the level-0 chain kernel on an LRC
    fine operator (:func:`compute_lrc_aux`):

        RABb = R (A_base Bb)   (coarse grid, k)
        H    = B^T Bb          (k, k)
        Bb_colsum              (k,)   the column sums of Bb

    with Bb the level-0 smoother's Woodbury factor of its sweep direction
    (the deferred chain recovers the correction's part of each sample's
    sum from Bb_colsum).  ``probe`` holds the kernel's responses to B, or
    None where the chain step forms b_eff = b + B wv on the grid."""

    RABb: torch.Tensor
    H: torch.Tensor
    Bb_colsum: torch.Tensor
    probe: "ChainProbe | None" = None


def compute_lrc_aux(ops, transfers, smoothers):
    """The :class:`LRCAux` of the level-0 chain kernel on an LRC fine
    operator, without a probe, or None when its smoother does not run
    it."""
    s0 = smoothers[0] if smoothers else None
    if not (
        isinstance(s0, GibbsSampler) and s0.is_lrc and s0.fd_params is not None and s0.has_kernel
        and s0.sweep in ("forward", "backward") and len(transfers) >= 1
    ):
        return None
    base0 = ops[0].base
    Bb = s0.woodbury().dense
    grid = list(range(base0.ndim))
    # one column at a time: no (k, *grid) temporaries at the fine size
    RABb = torch.stack(
        [transfers[0].restrict(base0.apply(Bb[..., j])) for j in range(Bb.shape[-1])], dim=-1
    )
    H = torch.tensordot(ops[0].B, Bb, dims=(grid, grid))
    return LRCAux(RABb=RABb, H=H, Bb_colsum=Bb.sum(dim=grid))


def attach_chain_b_response(smp, max_fill: float = 0.5):
    """``smp`` with the level-0 chain kernel's response to each column of
    B attached to its ``lrc_aux`` (a :class:`ChainProbe`), or ``smp``
    itself when the posterior chain does not run the kernel or B has no
    window view.

    The chain step is affine in its b stream, so the posterior's
    b_eff = b + B wv never needs to be formed: the kernel runs on the
    static b and the low-rank part is added after it,

        xpy(b + B wv) = xpy(b) + Mb wv,    rc(b + B wv) = rc(b) + RB wv,

    with Mb[:, j], RB[:, j] the kernel's own responses to column j: two
    calls under the same key (x = 0 and b = 0, then b = s_j B_j) differ
    only where B_j reaches, so the difference over s_j has exact compact
    support and is kept as windows (Mb, RB), with BtMb = B^T Mb and the
    column sums of Mb.  The stacks the step updates together are joined
    (:class:`~parmgmc_tpu_torch.operators.lrc.ColumnUnion`): the coarse
    [R A Bb, RB, B_c] and the fine [Mb, Bb], each packed on per-column
    union windows where every member has a window view.

    A kernel failure raises.  A response with no support raises (the
    kernel would ignore its b stream); so does a column of B that is zero
    everywhere.  Responses too wide for ``max_fill`` of the fine grid
    keep the b_eff route with a warning."""
    op0 = smp.ops[0]
    if (
        not isinstance(op0, LRCOperator)
        or not smp._lrc_chain_eligible()  # so lrc_aux is there
        or smp.lrc_aux.probe is not None
        or not op0.cols.windowed
    ):
        return smp
    gshape = tuple(smp.grid_shape)
    d = len(gshape)
    x0 = torch.zeros(gshape, dtype=op0.dtype, device=op0.device)
    # every probe call draws under one key (0)
    words = keys.Words()
    words.launch(*keys.draw_pair(0)[1:], (CHAIN_DOMAIN,))
    xpy0, rc0 = smp._fused_chain_down(x0, x0, words.cursor())
    cshape = tuple(rc0.shape)
    fine, coarse, btmb, colsum = [], [], [], []
    for j in range(op0.k):
        col = op0.B[..., j]
        peak = float(col.abs().max())
        if peak == 0.0:
            raise ValueError(f"column {j} of B is zero everywhere: it observes nothing")
        s_j = 1e6 / peak
        xpyj, rcj = smp._fused_chain_down(x0, (col * s_j).contiguous(), words.cursor())
        dm, dr = (xpyj - xpy0) / s_j, (rcj - rc0) / s_j
        bm, br = nonzero_bounds(dm), nonzero_bounds(dr)
        if bm is None or br is None:
            raise RuntimeError(f"the chain kernel shows no response to column {j} of its b stream")
        btmb.append(op0.bt_apply(dm))
        colsum.append(dm.sum())
        # only the windows are kept: one full-grid response alive at a time
        fine.append((dm[tuple(slice(lo, hi) for lo, hi in bm)], [lo for lo, _ in bm]))
        coarse.append((dr[tuple(slice(lo, hi) for lo, hi in br)], [lo for lo, _ in br]))
    # coarse windows are 8x smaller than the fine grid even when they cover
    # their whole level, so they are always taken
    Mb, RB = Columns.windows(fine, gshape, max_fill), Columns.windows(coarse, cshape, d + 8.0)
    if Mb is None or RB is None:
        warnings.warn(
            "the chain kernel's responses to B cover more than "
            f"{max_fill:g} of the grid: the posterior chain keeps the b_eff route",
            RuntimeWarning, stacklevel=2,
        )
        return smp
    aux, opc = smp.lrc_aux, smp.ops[1]
    # each route keeps its own summation order: one stack at a time RB
    # comes first and R A Bb is applied dense; the pack (the JAX package's)
    # holds [R A Bb, RB, B_c], R A Bb from its own windows
    coarse_union = ColumnUnion.of(
        [(Columns(aux.RABb), 1), (RB, 1), (opc.cols, -1)], cshape, order=(1, 0, 2),
        views=[Columns.of(aux.RABb, max_fill=d + 8.0), RB, opc.cols],
    )
    probe = ChainProbe(
        Mb=Mb, RB=RB, BtMb=torch.stack(btmb, dim=1), Mb_colsum=torch.stack(colsum),
        coarse=coarse_union, fine=ColumnUnion.of([(Mb, 1), (smp.smoothers[0].woodbury(), -1)], gshape),
    )
    return dataclasses.replace(smp, lrc_aux=dataclasses.replace(aux, probe=probe))


@dataclass(frozen=True, eq=False)
class MGMCSampler:
    """Stochastic V/W(n_pre, n_post)-cycle chain sampler for N(A^{-1}b, A^{-1}).

    ``lrc_aux`` holds the rank-k matrices of the LRC chain step, an
    :class:`LRCAux` (:func:`compute_lrc_aux`,
    :func:`attach_chain_b_response`); None on a prior.
    ``residual_packs`` holds, for each smoothed level the residual
    kernel takes (``kernels.residual_restrict.supported``), its view of the
    level's operator, None elsewhere (:meth:`_residual`)."""

    ops: tuple
    transfers: tuple
    smoothers: tuple
    coarse: object
    n_pre: int
    n_post: int
    n_levels: int
    n_coarse: int = 1
    gamma: int = 1
    lrc_aux: "LRCAux | None" = None
    residual_packs: "tuple | None" = None

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
        packs = tuple(residual_restrict.pack(o) if residual_restrict.supported(o, t) else None
                      for o, t in zip(ops, transfers))
        smp = MGMCSampler(
            ops=tuple(ops), transfers=tuple(transfers), smoothers=smoothers,
            coarse=coarse, n_pre=n_pre, n_post=n_post, n_levels=len(ops),
            n_coarse=n_coarse, gamma=gamma,
            lrc_aux=compute_lrc_aux(ops, transfers, smoothers),
            residual_packs=packs if any(p is not None for p in packs) else None,
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

    def _fused_chain_down(self, x, b, cur, z=None, with_xsum=False, with_zsum=False, out=None):
        """(xpy, rc, *partials): the level-0 chain kernel -- #1 up to
        ``_PLANE_LIMIT`` points a plane; above it the staged kernel when
        the deferred carry ``z`` is given (step_deferred), the windowed
        one when not (step) -- on the next launch of the cursor ``cur``
        (xpy into ``out`` when given).  step and step_deferred both come
        through here on the words of :meth:`keyed_words`, which keeps their
        sample sequences bit-identical (the three kernels compute the same
        function with the same draws)."""
        from parmgmc_tpu_torch.kernels import mg_sweep

        if not self._chain_level0_2d():
            fn = mg_sweep.fused_chain_down_fd
        elif z is not None:
            fn = mg_sweep.fused_chain_down_2d_staged
        else:
            fn = mg_sweep.fused_chain_down_2d
        s = self.smoothers[0]
        with span("pmg.mgmc.down0"):
            seed, step, at = cur.launch()
            return fn(
                x, b, s._coeff6(), s.fd_params[0], s.fd_params[1], s.omega, seed, step,
                sweep=s.sweep, z=z, with_xsum=with_xsum, with_zsum=with_zsum,
                **kernels.given(prefix_at=at, out=out),
            )

    def _fused_down(self, l: int, bl, cur):
        """(y, rc): level l's down-phase from zero in one
        ``fused_zero_gibbs_restrict_fd`` launch, on the next launch of
        ``cur``."""
        from parmgmc_tpu_torch.kernels.mg_sweep import fused_zero_gibbs_restrict_fd

        s = self.smoothers[l]
        with span("pmg.mgmc.level"):
            seed, step, at = cur.launch()
            return fused_zero_gibbs_restrict_fd(
                bl, s._coeff6(), s.fd_params[0], s.fd_params[1], s.omega, seed, step,
                sweep=s.sweep, **kernels.given(prefix_at=at),
            )

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

    def _fused_tail_cycle(self, l: int, bl, cur, out=None):
        """One keyed cycle over levels l .. coarsest on the cursor ``cur``:
        the smoothed levels' down-phases in the tail kernel, the coarse
        sample and the up-phase adds z_m = y_m + P z_{m+1} in plain torch
        (z_l into ``out`` when given)."""
        from parmgmc_tpu_torch.kernels.mg_tail import fused_tail_down

        shapes = tuple(tuple(self.ops[m].grid_shape) for m in range(l, self.n_levels))
        params = []
        for m in range(l, self.n_levels - 1):
            s = self.smoothers[m]
            params += [s.omega, s.fd_params[0], s.fd_params[1]]
        color0 = 0 if self.smoothers[l].sweep == "forward" else 1
        with span("pmg.mgmc.tail"):
            seed, step, at = cur.launch()
            ys, rhs = fused_tail_down(bl, params, seed, step, color0, shapes,
                                      **kernels.given(prefix_at=at))
        x = self._coarse_sample(rhs, cur)
        with span("pmg.mgmc.up"):
            for m in reversed(range(len(shapes) - 1)):
                x = self.transfers[l + m].prolong_add(ys[m], x, out=out if m == 0 else None)
        return x

    def _coarse_sample(self, bl, cur):
        """The coarsest level's sample from zero, n_coarse steps of the
        coarse sampler on the cursor ``cur``: a Cholesky sampler's on its
        words, any other's keyed from the key there."""
        with span("pmg.mgmc.coarse"):
            x = torch.zeros_like(bl)
            if not isinstance(self.coarse, CholeskySampler):
                key = cur.key()
                for _ in range(self.n_coarse):
                    key, x = self.coarse.step(key, x, bl)
                return x
            for _ in range(self.n_coarse):
                x = self.coarse.step_from(cur, x, bl)
            return x

    def _residual(self, l: int, x, b, restrict: bool = True):
        """R_l (b - A_l x), or b - A_l x where not ``restrict`` (b None: a
        zero right-hand side): one launch of the residual kernel where level
        l has its pack and x is a float32 grid on the card with no chain
        dims, else the same expression in plain torch (the kernel's twin),
        counted as ``residual_torch``."""
        op = self.ops[l]
        pack = None if self.residual_packs is None else self.residual_packs[l]
        if pack is not None and x.device.type == "cuda" and residual_restrict.takes(op, x, b):
            return residual_restrict.residual_restrict(
                x.contiguous(), None if b is None else b.contiguous(), op, restrict=restrict,
                packed=pack)
        kernels.count_launches({"residual_torch": 1})
        r = (torch.zeros_like(x) if b is None else bcast(b, x)) - op.apply(x)
        return self.transfers[l].restrict(r) if restrict else r

    def _cycle_general(self, l: int, bl, key):
        """Keyed cycle from zero at level l through the smoothers' keyed
        steps (``parmgmc_tpu`` ``_cycle_keyed``, general branch)."""
        if l == self.n_levels - 1:  # the coarse sample
            with span("pmg.mgmc.coarse"):
                x = torch.zeros_like(bl)
                for _ in range(self.n_coarse):
                    key, x = self.coarse.step(key, x, bl)
            return x
        smoother = self.smoothers[l]
        with span("pmg.mgmc.smooth"):
            x = torch.zeros_like(bl)
            for _ in range(self.n_pre):
                key, x = smoother.step(key, x, bl)
        key, sub = keys.split(key)
        with span("pmg.mgmc.restrict"):
            r = self._residual(l, x, bl)
        xc = self._cycle_general(l + 1, r, sub)
        for _ in range(1, self.gamma):  # W-cycle: iterate the coarse chain
            key, sub = keys.split(key)
            with span("pmg.mgmc.restrict"):
                rc = r - self.ops[l + 1].apply(xc)
            xc = xc + self._cycle_general(l + 1, rc, sub)
        with span("pmg.mgmc.up"):
            x = self.transfers[l].prolong_add(x, xc)
        with span("pmg.mgmc.smooth"):
            for _ in range(self.n_post):
                key, x = smoother.step(key, x, bl)
        return x

    def _cycle_keyed(self, l: int, bl, cur, out=None):
        """Keyed V(1,0) cycle from zero at level l (kernels throughout;
        only where :meth:`deferred_eligible`) on the cursor ``cur`` (the
        words of :meth:`_cycle_words`), into ``out`` when given.  LRC levels
        run the general keyed cycle (:meth:`_cycle_general_from`): the from-zero
        kernels know only the base stencil."""
        if l == self.n_levels - 1:
            x = self._coarse_sample(bl, cur)
            return x if out is None else out.copy_(x)
        if self.smoothers[l].is_lrc:
            return self._cycle_general_from(l, bl, cur, out)
        if self._tail_fused_eligible(l):
            return self._fused_tail_cycle(l, bl, cur, out)
        # any other level from zero, level 0 too (fmg_init)
        y, rc = self._fused_down(l, bl, cur)
        zc = self._cycle_keyed(l + 1, rc, cur)
        with span("pmg.mgmc.up"):
            return self.transfers[l].prolong_add(y, zc, out=out)

    def _cycle_general_from(self, l: int, bl, cur, out=None):
        """:meth:`_cycle_general` on the cursor ``cur`` (the words of
        :meth:`_general_words`), into ``out`` when given: a Gibbs
        smoother's steps and a Cholesky coarse sample on their words, any
        other level's cycle keyed from the key there.  The general keyed
        step runs it from level 0, the V(1,0) chain at its LRC levels."""
        if l == self.n_levels - 1:
            x = self._coarse_sample(bl, cur)
            return x if out is None else out.copy_(x)
        smoother = self.smoothers[l]
        if not isinstance(smoother, GibbsSampler):
            x = self._cycle_general(l, bl, cur.key())
            return x if out is None else out.copy_(x)
        with span("pmg.mgmc.smooth"):
            x = torch.zeros_like(bl)
            for _ in range(self.n_pre):
                x = smoother.step_from(cur, x, bl)
        with span("pmg.mgmc.restrict"):
            r = self._residual(l, x, bl)
        xc = self._cycle_general_from(l + 1, r, cur)
        for _ in range(1, self.gamma):  # W-cycle: iterate the coarse chain
            with span("pmg.mgmc.restrict"):
                rc = r - self.ops[l + 1].apply(xc)
            xc = xc + self._cycle_general_from(l + 1, rc, cur)
        with span("pmg.mgmc.up"):
            x = self.transfers[l].prolong_add(x, xc, out=out if self.n_post == 0 else None)
        with span("pmg.mgmc.smooth"):
            for _ in range(self.n_post):
                x = smoother.step_from(cur, x, bl)
        return x if out is None or self.n_post == 0 else out.copy_(x)

    # -- the integers the kernel route's keyed step hands the device ---------
    def keyed_words(self, key: int) -> keys.Words:
        """The integers the keyed step (:meth:`step`, and
        :meth:`step_deferred` where :meth:`deferred_eligible`) derives from
        ``key`` for the device, in the order it uses them; ``.key`` is the
        chain's next key.  On the V(1,0) kernel route: the level-0 low-rank
        draw's seed (LRC), #1's launch, then the cycle below
        (:meth:`_cycle_words`); on every other cycle the general cycle's
        (:meth:`_general_words`).  The one derivation of a step's draws:
        the eager step reads it through a cursor, a replayed capture
        (:mod:`parmgmc_tpu_torch.replay`) writes its prefixes and seeds to
        the graph's inputs."""
        words = keys.Words()
        key, sub = keys.split(key)
        if not self.deferred_eligible():
            self._general_words(0, sub, words)
            words.key = key
            return words
        if self.smoothers[0].is_lrc:
            sub, klr = keys.split(sub)
            words.seed(klr)
        sub, seed, step = keys.draw_pair(sub)
        words.launch(seed, step, (CHAIN_DOMAIN,))
        sub, sub2 = keys.split(sub)
        self._cycle_words(1, sub2, words)
        words.key = key
        return words

    def _cycle_words(self, l: int, key: int, words) -> None:
        """Append the words of :meth:`_cycle_keyed` at level l under
        ``key``: each kernel's launch (#2: one prefix a level), the coarse
        Cholesky draws' seeds; a coarse sampler of another kind keeps its
        key (:meth:`_coarse_sample`)."""
        if l == self.n_levels - 1:
            if not isinstance(self.coarse, CholeskySampler):
                return words.defer(key)
            for _ in range(self.n_coarse):
                key = self.coarse.step_words(key, words)
            return None
        if self.smoothers[l].is_lrc:
            return self._general_words(l, key, words)
        key, seed, step = keys.draw_pair(key)
        if self._tail_fused_eligible(l):
            words.launch(seed, step, [TAIL_DOMAIN + li for li in range(self.n_levels - 1 - l)])
            return self._cycle_words(self.n_levels - 1, key, words)
        words.launch(seed, step, (CHAIN_DOMAIN,))
        key, sub = keys.split(key)
        return self._cycle_words(l + 1, sub, words)

    def _general_words(self, l: int, key: int, words) -> None:
        """Append the words of :meth:`_cycle_general_from` at level l under
        ``key``, in :meth:`_cycle_general`'s order of splits: each Gibbs
        smoother's steps (:meth:`GibbsSampler.step_words`), the coarse
        sample's (:meth:`_cycle_words`); a level of another smoother keeps
        its key (``Words.defer``)."""
        if l == self.n_levels - 1:
            return self._cycle_words(l, key, words)
        smoother = self.smoothers[l]
        if not isinstance(smoother, GibbsSampler):
            return words.defer(key)
        for _ in range(self.n_pre):
            key = smoother.step_words(key, words)
        key, sub = keys.split(key)
        self._general_words(l + 1, sub, words)
        for _ in range(1, self.gamma):
            key, sub = keys.split(key)
            self._general_words(l + 1, sub, words)
        for _ in range(self.n_post):
            key = smoother.step_words(key, words)
        return None

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
        words = self.keyed_words(key)
        cur = words.cursor()
        x = self.step_from(cur, x, b)
        cur.close()
        return words.key, x

    def step_from(self, cur, x, b, out=None):
        """x': :meth:`step` on the words of :meth:`keyed_words`, read through
        the cursor ``cur``, into ``out`` when given (the static buffer of a
        captured step): the V(1,0) kernel route where
        :meth:`deferred_eligible`, else the general keyed cycle,
        x + M_mg(b - A x)."""
        if not self.deferred_eligible():
            with span("pmg.mgmc.restrict"):
                r = self._residual(0, x, b, restrict=False)
            y = self._cycle_general_from(0, r, cur)
            with span("pmg.mgmc.up"):
                return torch.add(x, y, out=out)
        if self.smoothers[0].is_lrc:
            with span("pmg.lrc"):
                xpy, rc, *_ = self._lrc_down(cur, x, b)
        else:
            xpy, rc = self._fused_chain_down(x, b, cur)
        z1 = self._cycle_keyed(1, rc, cur)
        with span("pmg.mgmc.up"):
            return self.transfers[0].prolong_add(xpy, z1, out=out)

    def _lrc_down(self, cur, x, b, z=None, btx=None, out=None, btx_out=None):
        """(x_out, rc, btx_next, sx, zsum): level 0's down-phase on an LRC
        fine operator -- the unchanged chain kernel with rank-k corrections
        around it, in plain torch on the device -- on the cursor ``cur``
        (the low-rank draw's generator, then #1's launch).

        With w = sqrt(Sigma^{-1}) eta_lr (k draws) and wv = w - Sigma^{-1}
        B^T x, the kernel run on b_eff = b + B wv performs the smoother's
        sweep with its low-rank noise and the low-rank part of the chain's
        residual.  Then, with c = B^T y (y the kernel's sweep),

            x_out = xpy - Bb c                       (the Woodbury correction)
            rc    = rc_kernel + R(A Bb) c - B_c (w + Sigma^{-1}(c - H c))

        remove what the kernel's restricted residual has that the true
        one has not (the noise B w, the correction it did not see, the
        low-rank part of the smoothed residual).  On the probed route
        (``lrc_aux.probe``) the kernel reads the static b and b_eff's
        low-rank part enters as the responses Mb wv and RB wv.

        ``z`` (the deferred carry, x = xpy + P z) and ``btx`` (B^T of the
        kernel's x when known) come from :meth:`step_deferred`, which also
        takes ``btx_next`` (B^T x_out on the probed route, else None), the
        sum of x_out ``sx`` and the kernel's ``zsum`` partials.  ``out`` and
        ``btx_out`` receive x_out and btx_next when given."""
        s = self.smoothers[0]
        op0, aux = self.fine_op, self.lrc_aux
        scale = s.sqrt_sigma_inv
        w = gibbs._lowrank_draw(cur.generator(scale.device), scale, 1)[0]
        if btx is None:
            btx = op0.bt_apply(x)
        if z is not None:
            btx = btx + self._bt_carry(z)
        wv = w - op0.sigma_inv * btx
        H, probe = aux.H, aux.probe
        sums = z is not None
        b_eff = b if probe is not None else (op0.b_apply(wv) if b is None else op0.b_apply_add(wv, b))
        xpy, rc, *partials = self._fused_chain_down(
            x, b_eff, cur, z=z, with_xsum=sums, with_zsum=sums, out=out
        )
        u = op0.bt_apply(xpy)
        c = u - btx
        if probe is not None:
            c = c + probe.BtMb @ wv
        cc = w + op0.sigma_inv * (c - H @ c)
        btx_next = sx = zsum = None
        if probe is not None:
            probe.coarse.add_((c, wv, cc), rc)
            probe.fine.add_((wv, c), xpy)
            # B^T(xpy + Mb wv - Bb c), by identity
            btx_next = torch.sub(u + probe.BtMb @ wv, H @ c, out=btx_out)
        else:
            rc = self.ops[1].b_apply_add_(-cc, rc.add_(aux.RABb @ c))
            s.woodbury().sub_(c, xpy)
        if sums:
            xsum, zsum = partials
            sx = xsum.sum() - aux.Bb_colsum @ c
            if probe is not None:
                sx = sx + probe.Mb_colsum @ wv
        return xpy, rc, btx_next, sx, zsum

    # -- deferred-prolong chain (lazy fine state) ------------------------------
    def _bt_carry(self, z):
        """B^T (P0 z) of a compact carry: B_c^T z with B_c = P^T B, the
        hierarchy's restricted columns (through their windows where they have them)."""
        return self.ops[1].bt_apply(z)

    def deferred_init(self, dtype, x=None):
        """Zero compact carry z (N0/2, N1/2, N2/2): the lazy state is the
        pair (xpy, z) standing for x = xpy + P0 z.  On the probed
        posterior route the carry is the pair (z, B^T x) for the chain's
        starting state ``x`` (zero when omitted): each step then takes the
        next B^T x from an identity instead of reading the k windows."""
        z = torch.zeros(coarse_shape(self.grid_shape), dtype=dtype, device=self.device)
        if self.lrc_aux is None or self.lrc_aux.probe is None:
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
        posterior route, and so is ``z'``.  The step runs on the words of
        :meth:`keyed_words` (:meth:`step_deferred_from`)."""
        self._require_deferred()
        words = self.keyed_words(key)
        cur = words.cursor()
        out = self.step_deferred_from(cur, xpy, z, b)
        cur.close()
        return (words.key, *out)

    def _require_deferred(self) -> None:
        if not self.deferred_eligible():
            raise NotImplementedError(
                "the deferred chain runs the V(1,0) chain kernels only (one "
                "forward/backward pre-sweep, no post-sweep, gamma = 1, FD float32 "
                "levels under aggregation with even extents), as the JAX "
                "deferred_eligible; use sample_chain"
            )

    def step_deferred_from(self, cur, xpy, z, b, out=None):
        """(xpy', z', sum_xpy', zprev_sum): :meth:`step_deferred` on the
        words of :meth:`keyed_words`, read through the cursor ``cur``.  With
        ``out`` = (xpy_out, z_out), z_out shaped as ``z``, the new lazy
        state is written there: the static buffers of a captured step."""
        self._require_deferred()
        gibbs.refuse_batch(self, xpy.shape[len(self.grid_shape):])
        pair = isinstance(z, tuple)
        z, btx = z if pair else (z, None)
        x_out, z_out = (None, None) if out is None else out
        z_out, btx_out = z_out if pair and z_out is not None else (z_out, None)
        if self.smoothers[0].is_lrc:
            with span("pmg.lrc"):
                xpy2, rc, btx, sx, zsum = self._lrc_down(cur, xpy, b, z=z, btx=btx, out=x_out,
                                                         btx_out=btx_out)
        else:
            xpy2, rc, xsum, zsum = self._fused_chain_down(
                xpy, b, cur, z=z, with_xsum=True, with_zsum=True, out=x_out
            )
            sx = xsum.sum()
        zn = self._cycle_keyed(1, rc, cur, out=z_out)
        return xpy2, ((zn, btx) if pair else zn), sx, 8.0 * zsum.sum()

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
        for l in reversed(range(self.n_levels - 1)):
            x = self.transfers[l].prolong(x)
            for _ in range(n_cycles):
                key, sub = keys.split(key)
                r = self._residual(l, x, bs[l], restrict=False)
                if not self.deferred_eligible():
                    x = x + self._cycle_general(l, r, sub)
                    continue
                words = keys.Words()
                self._cycle_words(l, sub, words)
                cur = words.cursor()
                x = x + self._cycle_keyed(l, r, cur)
                cur.close()
        return key, x
