"""The plain V(1,0) prior reference of :mod:`.gmrf`, worked in slabs.

The same chain as ``gmrf.Chain`` with ``obs=None``: the same operator and
hierarchy, the same arithmetic in the same order, the same draws by the
step's key (:mod:`.keys`, :mod:`.noise`), the same tail and per-level
keying, and the same ``store`` rounding for the control.  It differs in
where the numbers live.  ``gmrf.Level`` keeps D, sqrt(D), the parity and
the flat index as grid-sized tensors, and its neighbour sum makes six
shifted copies of a whole field: a 768^3 step then peaks near 20 float64
fields, more than one 80 GB card holds.  Here every level is worked in
slabs of axis-0 planes with a one-plane halo.  A slab's diagonal, parity
and flat index come from index arithmetic, and its neighbour sum from the
slab and its halo.  So the only grid-sized tensors of a step are the
chain's own: the state, the residual, the sweep and the sweep's
right-hand side.

A sweep from zero takes two passes over the slabs: the red points of
every slab, then the black points, whose neighbours are all red (a black
update written in place is never read by another black point).  The
residual and its 2x2x2 restriction take slabs of an even count of planes.
Each slab sums the same terms in the same order as the whole field, so
the two references agree to roundoff, and bit for bit where the library's
elementwise functions give the same bits on a slab as on the whole."""

from __future__ import annotations

import torch

from portbench.reference import gmrf, keys, noise

SLAB_POINTS = 1 << 25  # grid points of a slab by default (float64: 256 MiB)


class Level:
    """One n^3 level of the hierarchy, worked in slabs of ``slab`` planes:
    it holds only per-axis vectors, never a grid-sized tensor."""

    def __init__(self, n, kappa2, hinv2, dtype, device, slab):
        self.shape, self.n, self.slab = (n, n, n), n, max(1, int(slab))
        self.kappa2, self.hinv2_f = kappa2, hinv2
        self.hinv2 = torch.tensor(hinv2, dtype=dtype, device=device)
        self.i = torch.arange(n, device=device)
        self.links = (self.i >= 1).to(dtype) + (self.i <= n - 2).to(dtype)

    def slabs(self, even=False):
        """[(a, b)]: the slabs' plane ranges; of an even count of planes
        (but the grid's last) where ``even``."""
        s = self.slab + (self.slab % 2 if even else 0)
        return [(a, min(a + s, self.n)) for a in range(0, self.n, s)]

    def D(self, a, b):
        """The diagonal on planes a..b-1, summed as ``gmrf._links`` sums it."""
        n = self.n
        links = torch.zeros((b - a, n, n), dtype=self.links.dtype, device=self.links.device)
        links = links + self.links[a:b].reshape(b - a, 1, 1)
        links = links + self.links.reshape(1, n, 1)
        links = links + self.links.reshape(1, 1, n)
        return self.kappa2 + self.hinv2_f * links

    def parity(self, a, b):
        i = self.i
        return (i[a:b, None, None] + i[None, :, None] + i[None, None, :]) % 2

    def index(self, a, b):
        """Flat indices of planes a..b-1 (int64)."""
        n2 = self.n * self.n
        return torch.arange(a * n2, b * n2, device=self.i.device, dtype=torch.int64).reshape(b - a, self.n, self.n)

    def neigh_sum(self, v, a, b):
        """``gmrf._neigh_sum(v)`` on planes a..b-1, from the slab and its halo."""
        lo, hi = max(a - 1, 0), min(b + 1, self.n)
        return gmrf._neigh_sum(v[lo:hi])[a - lo:b - lo]

    def apply(self, v, a, b):
        """(A v) on planes a..b-1."""
        return self.D(a, b) * v[a:b] - self.hinv2 * self.neigh_sum(v, a, b)

    def gibbs_from_zero(self, rhs, prefix):
        """``gmrf.Level.gibbs_from_zero(rhs, prefix)`` of the prior: the
        forward red/black sweep from zero on rhs + sqrt(D) eta."""
        bt, y = torch.empty_like(rhs), torch.empty_like(rhs)
        for a, b in self.slabs():
            d = self.D(a, b)
            bt[a:b] = rhs[a:b] + torch.sqrt(d) * noise.eta(prefix, self.index(a, b), rhs.dtype)
            y[a:b] = torch.where(self.parity(a, b) == 0, bt[a:b] / d, 0.0)
        for a, b in self.slabs():
            upd = (bt[a:b] + self.hinv2 * self.neigh_sum(y, a, b)) / self.D(a, b)
            y[a:b] = torch.where(self.parity(a, b) == 1, upd, y[a:b])
        return y

    def restricted_residual(self, rhs, y, st):
        """st(R (rhs - A y)), the 2x2x2 block sums, slab by slab."""
        n = self.n // 2
        rc = torch.empty((n, n, n), dtype=y.dtype, device=y.device)
        for a, b in self.slabs(even=True):
            rc[a // 2:b // 2] = st(gmrf.restrict(rhs[a:b] - self.apply(y, a, b)))
        return rc

    def prolong_into(self, y, z, st):
        """y <- st(y + P z), the injection of the coarse z, slab by slab."""
        for a, b in self.slabs(even=True):
            y[a:b] = st(y[a:b] + gmrf.prolong(z[a // 2:b // 2]))


class Chain:
    """The reference chain of the prior, slab-wise (``gmrf.Chain``'s
    arguments; ``slab``: planes a slab, by default about
    :data:`SLAB_POINTS` points)."""

    draw_dtype = torch.float32
    # gmrf.Chain's storage rounding, coarse sample and tail rule, as they are
    _st = gmrf.Chain._st
    _coarse = gmrf.Chain._coarse
    _tail_ok = gmrf.Chain._tail_ok

    def __init__(self, n, kappa, coarsest_size, dtype, device, obs=None, store=None, slab=None):
        if obs is not None:
            raise ValueError("the slab reference follows the prior alone")
        self.dtype, self.device, self.store = dtype, device, store
        kappa2, hinv2 = float(kappa) ** 2, float((n - 1) ** 2)
        self.levels = []
        while True:
            planes = slab if slab is not None else max(1, SLAB_POINTS // (n * n))
            self.levels.append(Level(n, kappa2, hinv2, dtype, device, planes))
            if not ((n // 2) ** 3 >= coarsest_size and n > 2):
                break
            n, kappa2, hinv2 = n // 2, 8.0 * kappa2, 4.0 * hinv2
        # the coarsest level's dense precision and its Cholesky factor, as
        # gmrf.Chain makes them (from a gmrf.Level of that small grid)
        last = gmrf.Level(n, kappa2, hinv2, dtype, device)
        m = last.D.numel()
        fdt = torch.float64 if dtype == torch.float64 else torch.float32
        eye = torch.eye(m, dtype=fdt, device=device).reshape(m, *last.shape)
        A = torch.stack([gmrf.Level.apply(last, e.to(dtype)).to(fdt).reshape(-1) for e in eye])
        L = torch.linalg.cholesky(0.5 * (A + A.T))
        self.Li = torch.linalg.solve_triangular(L, torch.eye(m, dtype=fdt, device=device), upper=False).to(dtype)

    def _st_into(self, lev, t):
        """t <- st(t), slab by slab."""
        if self.store is not None:
            for a, b in lev.slabs():
                t[a:b] = self._st(t[a:b])

    def _prior(self, l, rhs, key):
        """``gmrf.Chain._prior``: levels l .. coarsest."""
        if l == len(self.levels) - 1:
            return self._coarse(key, rhs)
        if self._tail_ok(l):
            return self._tail(l, rhs, key)
        lev = self.levels[l]
        key, k1, k2 = keys.split(key, 3)
        y = lev.gibbs_from_zero(rhs, noise.hash_prefix(keys.randint31(k1), keys.randint31(k2),
                                                       noise.CHAIN_DOMAIN))
        self._st_into(lev, y)
        rc = lev.restricted_residual(rhs, y, self._st)
        key, sub = keys.split(key)
        lev.prolong_into(y, self._prior(l + 1, rc, sub), self._st)
        return y

    def _tail(self, l, rhs, key):
        """``gmrf.Chain._tail``: levels l .. coarsest keyed as one call."""
        key, k1, k2 = keys.split(key, 3)
        seed, step = keys.randint31(k1), keys.randint31(k2)
        ys = []
        for li, lev in enumerate(self.levels[l:-1]):
            y = lev.gibbs_from_zero(rhs, noise.hash_prefix(seed, step, noise.TAIL_DOMAIN + li))
            self._st_into(lev, y)
            rhs = lev.restricted_residual(rhs, y, self._st)
            ys.append(y)
        x = self._coarse(key, rhs)
        for lev, y in reversed(list(zip(self.levels[l:-1], ys))):
            lev.prolong_into(y, x, self._st)
            x = y
        return x

    def step(self, key: int, x):
        """(key', x'): one chain step from ``x``, which is overwritten."""
        key, sub = keys.split(key)
        sub, k1, k2 = keys.split(sub, 3)
        lev = self.levels[0]
        r = torch.empty_like(x)
        for a, b in lev.slabs():
            r[a:b] = -lev.apply(x, a, b)
        y = lev.gibbs_from_zero(r, noise.hash_prefix(keys.randint31(k1), keys.randint31(k2),
                                                     noise.CHAIN_DOMAIN))
        rc = lev.restricted_residual(r, y, self._st)
        del r
        sub, sub2 = keys.split(sub)
        z = self._prior(1, rc, sub2)
        for a, b in lev.slabs(even=True):
            x[a:b] = self._st(self._st(x[a:b] + y[a:b]) + gmrf.prolong(z[a // 2:b // 2]))
        return key, x

    def follow(self, key: int, x, n_steps: int):
        """(x_final, qoi (n_steps,)): ``n_steps`` steps from ``x`` (left
        as it is), the field mean after each."""
        x = self._st(x.to(self.dtype, copy=True))
        q = []
        for _ in range(n_steps):
            key, x = self.step(key, x)
            q.append(x.mean())
        return x, torch.stack(q)
