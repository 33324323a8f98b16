"""Plain-torch reference of the aggregate V(n_pre, n_post) MGMC chain step
on a 3D GMRF prior, worked in slabs of axis-0 planes.

The configuration: :mod:`.gmrf`'s operator and aggregate hierarchy (the
7-point shifted Laplacian in link-count form on an n^3 grid, every extent
halved by 2x2x2 aggregation down to the first grid under ``coarsest_size``
points; its FD levels in closed form, kappa2' = 8 kappa2, hinv2' = 4 hinv2;
restriction the block sums, prolongation the injection) and a dense
Cholesky sample at the coarsest level.  A chain step of the prior is

    x <- x + M(0 - A x),

M the V(n_pre, n_post) cycle from zero, as ``gmrf_galerkin.Chain.cycle``
runs it: at each level above the coarsest n_pre forward red/black Gibbs
sweeps (red points, (i + j + k) even, first), the residual restricted by
block sums, the coarse correction, y + P x_c, n_post more sweeps; the
Cholesky sample at the coarsest.  A sweep from the state y on the
right-hand side rhs updates each colour at once on
b~ = rhs + sqrt((2 - omega)/omega) sqrt(D) eta.  Keys split in the
program's order of the general keyed cycle (the step's key into the next
key and the cycle's; at each level a key a sweep, then one split for the
level below), each sweep's draws counter-hashed from a (seed, 2 step)
pair of its key under :data:`.noise.SWEEP_DOMAIN`, the coarse sample's
from the generator of its key (the program's published conventions,
:mod:`.keys`, :mod:`.noise`).  Nothing here reads what the program built.

Every level is worked in slabs with a one-plane halo, with
``gmrf_slabs.Level``'s slab arithmetic (the diagonal, parity and flat
index of a slab from index arithmetic, the neighbour sum from the slab and
its halo), so the only grid-sized tensors of a level are the state, the
right-hand side, the sweep and the sweep's b~.  A sweep from any state
takes two passes over the slabs: every slab's red points, then the black
(a point's neighbours are all of the other colour, so an update written in
place is read by no point of its own colour).  The residual and its
restriction take slabs of an even count of planes.

Departures from upstream ParMGMC (MGMC V-cycle, Gibbs smoothers, Cholesky
coarse): its smoothers sweep each process's rows in PETSc's SOR order,
here the red/black colouring the program uses (the same chain law); its
draws come from PETSc's generator, here the counter hash and
``torch.Generator``; its hierarchy is algebraic or geometric, here the
2x2x2 aggregation; its coarse Cholesky factors a sparse matrix, here the
dense one.

The arithmetic runs in the precision the caller names (float64 for the
reference), the generator's draws in float32 as the program makes them.
The control (``store=torch.bfloat16``) computes in float32 and rounds every
field a step stores -- the state, each sweep, the fine right-hand side,
the restricted residual, the coarse sample, each prolonged sum -- to
bfloat16, as a kernel that kept its fields in bfloat16 would.
"""

from __future__ import annotations

import torch

from portbench.reference import gmrf_slabs, keys, noise


class Chain(gmrf_slabs.Chain):
    """The reference chain: ``gmrf_slabs.Chain``'s slab-wise levels, coarse
    factor, storage rounding and ``follow``, stepped by the V(n_pre,
    n_post) cycle (``slab``: planes a slab, by default about
    :data:`.gmrf_slabs.SLAB_POINTS` points)."""

    def __init__(self, n, kappa, coarsest_size, n_pre, n_post, omega, dtype, device, store=None,
                 slab=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(n, kappa, coarsest_size, dtype, device, store=store, slab=slab)
        if len(self.levels) < 2 or any(lev.n % 2 for lev in self.levels[:-1]):
            raise ValueError(f"the aggregate cycle halves even extents above the coarsest, not "
                             f"{[lev.n for lev in self.levels]}")
        self.n_pre, self.n_post, self.omega = int(n_pre), int(n_post), float(omega)
        self.nfac = ((2.0 - self.omega) / self.omega) ** 0.5

    def _sweep(self, lev, rhs, y, key):
        """(key', y'): one forward red/black sweep from ``y`` (overwritten)
        on ``rhs``, its draws from ``key``."""
        key, k1, k2 = keys.split(key, 3)
        prefix = noise.hash_prefix(keys.randint31(k1), keys.randint31(k2) * 2, noise.SWEEP_DOMAIN)
        bt = torch.empty_like(rhs)
        for a, b in lev.slabs():
            eta = noise.eta(prefix, lev.index(a, b), rhs.dtype)
            bt[a:b] = rhs[a:b] + self.nfac * torch.sqrt(lev.D(a, b)) * eta
        for color in (0, 1):
            for a, b in lev.slabs():
                upd = (1.0 - self.omega) * y[a:b] + self.omega * (
                    bt[a:b] + lev.hinv2 * lev.neigh_sum(y, a, b)) / lev.D(a, b)
                y[a:b] = torch.where(lev.parity(a, b) == color, upd, y[a:b])
        del bt
        self._st_into(lev, y)
        return key, y

    def cycle(self, l, rhs, key):
        """The V-cycle from zero at level l on ``rhs`` under ``key``."""
        if l == len(self.levels) - 1:
            return self._coarse(key, rhs)
        lev = self.levels[l]
        y = torch.zeros_like(rhs)
        for _ in range(self.n_pre):
            key, y = self._sweep(lev, rhs, y, key)
        key, sub = keys.split(key)
        rc = lev.restricted_residual(rhs, y, self._st)
        xc = self.cycle(l + 1, rc, sub)
        del rc
        lev.prolong_into(y, xc, self._st)
        del xc
        for _ in range(self.n_post):
            key, y = self._sweep(lev, rhs, y, key)
        return y

    def step(self, key: int, x):
        """(key', x'): one chain step of the prior (b = 0) from ``x``, which
        is overwritten."""
        key, sub = keys.split(key)
        lev = self.levels[0]
        r = torch.empty_like(x)
        for a, b in lev.slabs():
            r[a:b] = self._st(-lev.apply(x, a, b))
        y = self.cycle(0, r, sub)
        del r
        for a, b in lev.slabs():
            x[a:b] = self._st(x[a:b] + y[a:b])
        return key, x
