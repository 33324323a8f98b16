"""Multigrid Monte Carlo (MGMC) sampler (port of ``parmgmc_tpu.samplers.mgmc``,
prior path).

A stochastic V/W-cycle whose level smoothers are Gibbs samplers and whose
coarsest level is an exact Cholesky sample, driven as the chain

    x <- x + M_mg(b - A x).

Three routes through the same sampler:

* ``step_with_noise(x, b, noises)`` -- the general explicit-noise cycle
  (any n_pre/n_post/gamma/sweep), plain torch; the oracle side of the
  tests and the body of the explicit-noise chains.
* ``step(key, x, b)`` / ``step_deferred`` on a V(1,0) cycle of link-count
  FD levels in float32 -- the chain kernels, routed as the JAX package
  routes its own: level 0 in one
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
  full-sweep kernel launch per half-sweep, see
  :class:`~parmgmc_tpu_torch.samplers.gibbs.GibbsSampler`; levels whose
  planes pass ``_PLANE_LIMIT`` take the large-plane sweep kernels), residuals,
  transfers and the coarse sample in plain torch, gamma coarse
  iterations per level.

Keyed configurations outside the port's slices (2D grids, odd extents)
raise ``NotImplementedError`` naming their ``ROADMAP.md`` item; they are
never emulated.

The hierarchy is the closed-form aggregate Galerkin one: P^T A P of a
link-count FD operator under 2^d block aggregation is again link-count
FD with kappa2' = 2^d kappa2 and hinv2' = 2^(d-1) hinv2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.operators.stencil import (
    FDStencilOperator,
    StencilOperator,
    coarse_shape,
    detect_fd_params,
    fd_stencil,
)
from parmgmc_tpu_torch.operators.transfer import AggregateTransfer
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler

__all__ = ["MGMCSampler", "build_hierarchy"]


def build_hierarchy(op, n_levels=None, coarsest_size=128, coarsening="linear"):
    """(ops, transfers): per-level operators by closed-form aggregate
    Galerkin coarsening of a link-count FD operator.

    The default is the JAX package's, ``"linear"``; its transfer needs the
    comb-probed Galerkin product, so it raises where the first transfer
    would be built (a one-level hierarchy builds with any value).  Pass
    ``coarsening="aggregate"`` for the closed-form hierarchy."""
    if not isinstance(op, StencilOperator):
        raise NotImplementedError(
            "MGMC on LRC or graph operators is ROADMAP.md items 13 and 20"
        )
    ops, transfers = [op], []
    while True:
        cur = ops[-1]
        gshape = cur.grid_shape
        if n_levels is not None and len(ops) >= n_levels:
            break
        if n_levels is None and math.prod(coarse_shape(gshape)) < coarsest_size:
            break
        if any(s <= 2 for s in gshape):
            break
        if coarsening != "aggregate":
            raise NotImplementedError(
                f"coarsening={coarsening!r} needs the comb-probed Galerkin product "
                "(ROADMAP.md item 18); pass coarsening='aggregate'"
            )
        fd = detect_fd_params(cur) if all(s % 2 == 0 for s in gshape) else None
        if fd is None:
            raise NotImplementedError(
                f"aggregate coarsening of {gshape} needs the comb-probed Galerkin "
                "product for odd extents or non-FD stencils (ROADMAP.md item 18)"
            )
        d = len(gshape)
        transfers.append(AggregateTransfer(fine_shape=tuple(gshape)))
        ops.append(
            fd_stencil(
                coarse_shape(gshape),
                (2**d) * fd[0],
                (2 ** (d - 1)) * fd[1],
                dtype=cur.dtype,
                device=cur.device,
                lazy=True if isinstance(cur, FDStencilOperator) else "auto",
            )
        )
    return ops, tuple(transfers)


@dataclass(frozen=True, eq=False)
class MGMCSampler:
    """Stochastic V/W(n_pre, n_post)-cycle chain sampler for N(A^{-1}b, A^{-1})."""

    ops: tuple
    transfers: tuple
    smoothers: tuple
    coarse: object
    n_pre: int
    n_post: int
    n_levels: int
    n_coarse: int = 1
    gamma: int = 1

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
                    n_post=1, n_coarse=1, gamma=1) -> "MGMCSampler":
        smoothers = tuple(GibbsSampler.create(o, omega=omega, sweep=sweep) for o in ops[:-1])
        return MGMCSampler(
            ops=tuple(ops), transfers=tuple(transfers), smoothers=smoothers,
            coarse=coarse, n_pre=n_pre, n_post=n_post, n_levels=len(ops),
            n_coarse=n_coarse, gamma=gamma,
        )

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
        is a zero RHS."""
        if b is None:
            b = torch.zeros_like(x)
        return x + self._cycle(0, b - self.fine_op.apply(x), noises)

    def prepare(self, b):
        return None

    # -- keyed cycle on the kernels -------------------------------------------
    def _keyed_unsupported(self) -> "str | None":
        """Why no keyed path can run this sampler, or None."""
        if self.n_levels < 2:
            return "a one-level MGMC sampler has no cycle; use CholeskySampler"
        for l in range(self.n_levels - 1):
            gs = self.ops[l].grid_shape
            if len(gs) != 3 or any(d % 2 for d in gs):
                return (
                    f"level {l} grid {gs} is not 3D with even extents "
                    "(ROADMAP.md item 18)"
                )
        return None

    def _require_keyed(self):
        why = self._keyed_unsupported()
        if why is not None:
            raise NotImplementedError(why)

    def deferred_eligible(self) -> bool:
        """Does the keyed step run the V(1,0) chain kernels (and so admit
        the deferred chain)?  One forward or backward pre-sweep, no
        post-sweep, gamma = 1, every smoothed level link-count FD in
        float32 (the JAX ``_down_fused_eligible`` / ``deferred_eligible``
        shape, without the Mosaic gates)."""
        if self.n_pre != 1 or self.n_post != 0 or self.gamma != 1:
            return False
        if self._keyed_unsupported() is not None:
            return False
        sweep = self.smoothers[0].sweep
        return sweep in ("forward", "backward") and all(
            s.sweep == sweep and s.fd_params is not None and s.has_kernel
            for s in self.smoothers
        )

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
        only where :meth:`deferred_eligible`)."""
        if l == self.n_levels - 1:
            x = torch.zeros_like(bl)
            for _ in range(self.n_coarse):
                key, x = self.coarse.step(key, x, bl)
            return x
        if self._tail_fused_eligible(l):
            return self._fused_tail_cycle(l, bl, key)
        # any other level from zero, level 0 too (fmg_init)
        y, rc, key = self._fused_down(l, bl, key)
        key, sub = keys.split(key)
        return self.transfers[l].prolong_add(y, self._cycle_keyed(l + 1, rc, sub))

    def step(self, key: int, x, b, aux=None):
        """(key, x'): one keyed chain step.  ``b=None`` declares a zero RHS:
        the chain kernel then reads no b at all, the general cycle
        substitutes zeros for the fine residual."""
        key, sub = keys.split(key)
        if not self.deferred_eligible():
            self._require_keyed()
            bz = torch.zeros_like(x) if b is None else b
            return key, x + self._cycle_general(0, bz - self.fine_op.apply(x), sub)
        xpy, rc, sub = self._fused_chain_down(x, b, sub)
        sub, sub2 = keys.split(sub)
        z1 = self._cycle_keyed(1, rc, sub2)
        return key, self.transfers[0].prolong_add(xpy, z1)

    # -- deferred-prolong chain (lazy fine state) ------------------------------
    def deferred_init(self, dtype):
        """Zero compact carry z (N0/2, N1/2, N2/2): the lazy state is the
        pair (xpy, z) standing for x = xpy + P0 z."""
        return torch.zeros(coarse_shape(self.grid_shape), dtype=dtype, device=self.device)

    def step_deferred(self, key: int, xpy, z, b):
        """(key, xpy', z', sum_xpy', zprev_sum): lazy chain step.

        The prolong-add x = xpy + P0 z of the previous step happens inside
        this step's chain kernel, so x is never written.  Bit-identical
        samples to :meth:`step` under the same key: the kernel performs the
        same adds.  ``sum_xpy'`` is the sum of xpy' (from the kernel's
        partial sums); ``zprev_sum`` = sum(P0 z) of the carry it consumed,
        i.e. the rest of the PREVIOUS sample's sum."""
        if not self.deferred_eligible():
            self._require_keyed()
            raise NotImplementedError(
                "the deferred chain runs the V(1,0) chain kernels only (one "
                "forward/backward pre-sweep, no post-sweep, gamma = 1, FD float32 "
                "levels), as the JAX deferred_eligible; use sample_chain"
            )
        key, sub = keys.split(key)
        xpy2, rc, sub, xsum, zsum = self._fused_chain_down(
            xpy, b, sub, z=z, with_xsum=True, with_zsum=True
        )
        sub, sub2 = keys.split(sub)
        zn = self._cycle_keyed(1, rc, sub2)
        return key, xpy2, zn, xsum.sum(), 8.0 * zsum.sum()

    def deferred_final_sum(self, z):
        """sum(P0 z) for a compact carry: each coarse cell covers 8 fine."""
        return 8.0 * z.sum()

    def materialize_deferred(self, xpy, z):
        """The sample the lazy pair represents: xpy + P0 z."""
        return self.transfers[0].prolong_add(xpy, z)

    def fmg_init(self, key: int, b, n_cycles: int = 1):
        """(key, x0): full-multigrid cold start -- an exact coarsest draw,
        prolonged and refined by ``n_cycles`` keyed cycles per level, so
        chains started from it need almost no burn-in."""
        self._require_keyed()
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
