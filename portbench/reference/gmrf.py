"""Plain-torch reference of the MGMC V(1,0) chain step on a 3D GMRF.

The configuration: the 7-point shifted Laplacian in link-count form on an
n^3 grid of [0, 1]^3 (off-diagonals -hinv2, hinv2 = (n - 1)^2; diagonal
kappa^2 + hinv2 per in-grid neighbour), optionally conditioned on ball
averages y = B^T x + noise of variance sigma2 (the posterior precision
A + B Sigma^{-1} B^T, right-hand side f = B Sigma^{-1} y).  The hierarchy
halves every extent by 2x2x2 aggregation (restriction = block sums,
prolongation = injection) down to the first grid under ``coarsest_size``
points; its FD levels follow in closed form (kappa2' = 8 kappa2,
hinv2' = 4 hinv2) and each column of B is restricted.  A chain step is

    x <- x + M_mg(b - A x)

with one forward red/black Gibbs sweep from zero at every level above the
coarsest (omega = 1: red points first), the restricted residual passed
down, an exact Cholesky sample at the coarsest level, and the coarse
corrections injected back up.  On the posterior each sweep draws the
low-rank noise B w, w = Sigma^{-1/2} eta_lr, beside the point noise and is
followed by the Woodbury correction y <- y - Bb (B^T y), Bb = M^{-1} B
(Sigma + B^T M^{-1} B)^{-1}, M^{-1} the deterministic sweep from zero.

Every draw comes from the step's integer key by the program's published
conventions (:mod:`.keys`, :mod:`.noise`); the arithmetic runs in the
precision the caller names (float64 for the reference).  The control
(``store=torch.bfloat16``) computes in float32 and rounds every field a
step stores -- the state, each level's sweep, right-hand side and
restricted residual, the coarse sample -- to bfloat16, as a kernel that
kept its fields in bfloat16 would.  Nothing here reads what the program
built.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import keys, noise


def _shift(v, axis, by):
    """v[..., i + by, ...] along ``axis`` with zero fill (|by| = 1)."""
    n = v.shape[axis]
    zshape = list(v.shape)
    zshape[axis] = 1
    z = v.new_zeros(zshape)
    if by > 0:
        return torch.cat([v.narrow(axis, 1, n - 1), z], dim=axis)
    return torch.cat([z, v.narrow(axis, 0, n - 1)], dim=axis)


def _neigh_sum(v):
    """Sum of the six grid neighbours, zero outside the grid."""
    return sum(_shift(v, a, s) for a in range(3) for s in (-1, 1))


def _links(shape, dtype, device):
    out = torch.zeros(shape, dtype=dtype, device=device)
    for ax, n in enumerate(shape):
        i = torch.arange(n, device=device)
        view = [1, 1, 1]
        view[ax] = n
        out = out + ((i >= 1).to(dtype) + (i <= n - 2).to(dtype)).reshape(view)
    return out


def restrict(v):
    """2x2x2 block sums of the leading three axes."""
    n0, n1, n2 = v.shape[:3]
    rest = v.shape[3:]
    return v.reshape(n0 // 2, 2, n1 // 2, 2, n2 // 2, 2, *rest).sum(dim=(1, 3, 5))


def prolong(v):
    """Injection of a coarse field into its 2x2x2 blocks."""
    n0, n1, n2 = v.shape
    return v[:, None, :, None, :, None].expand(n0, 2, n1, 2, n2, 2).reshape(2 * n0, 2 * n1, 2 * n2)


def ball_columns(n, coords, radii, dtype, device):
    """(k, n, n, n): column j of B is the lumped mass (h^3, halved once a
    boundary axis) times the indicator of ball j over its volume."""
    h = 1.0 / (n - 1)
    w1 = np.full(n, h)
    w1[0] = w1[-1] = h / 2
    mass = w1[:, None, None] * w1[None, :, None] * w1[None, None, :]
    t = np.linspace(0.0, 1.0, n)
    cols = []
    for c, r in zip(np.asarray(coords, float), np.asarray(radii, float)):
        d2 = ((t - c[0]) ** 2)[:, None, None] + ((t - c[1]) ** 2)[None, :, None] + ((t - c[2]) ** 2)[None, None, :]
        ind = (d2 < r * r) / (4.0 * math.pi / 3.0 * r**3)
        cols.append(torch.from_numpy(mass * ind).to(device=device, dtype=dtype))
    return torch.stack(cols)


class Level:
    """One grid level: the FD operator and, on a posterior, its B."""

    def __init__(self, n, kappa2, hinv2, dtype, device, B=None, sigma_inv=None):
        self.shape = (n, n, n)
        self.hinv2 = torch.tensor(hinv2, dtype=dtype, device=device)
        self.D = kappa2 + hinv2 * _links(self.shape, dtype, device)
        self.sqrtD = torch.sqrt(self.D)
        i = torch.arange(n, device=device)
        self.par = (i[:, None, None] + i[None, :, None] + i[None, None, :]) % 2
        self.idx = torch.arange(n**3, device=device, dtype=torch.int64).reshape(self.shape)
        self.B, self.sigma_inv = B, sigma_inv
        self.Bb = None
        if B is not None:
            # Bb = M^{-1} B (Sigma + B^T M^{-1} B)^{-1}
            C = torch.stack([self.sweep(b, torch.zeros_like(b)) for b in B])
            small = torch.diag(1.0 / sigma_inv) + torch.einsum("iabc,jabc->ij", B, C)
            self.Bb = torch.einsum("jabc,ji->iabc", C, torch.linalg.inv(small.double()).to(dtype))

    def apply_base(self, x):
        return self.D * x - self.hinv2 * _neigh_sum(x)

    def bt(self, x):
        return torch.einsum("iabc,abc->i", self.B, x)

    def apply(self, x):
        """The level's precision: A x, plus B Sigma^{-1} B^T x on a posterior."""
        ax = self.apply_base(x)
        if self.B is not None:
            ax = ax + torch.einsum("iabc,i->abc", self.B, self.sigma_inv * self.bt(x))
        return ax

    def sweep(self, bt, x):
        """One forward red/black Gibbs-Seidel sweep (omega = 1) on the base
        operator with the right-hand side ``bt``: red points first."""
        for color in (0, 1):
            upd = (bt + self.hinv2 * _neigh_sum(x)) / self.D
            x = torch.where(self.par == color, upd, x)
        return x

    def gibbs_from_zero(self, rhs, prefix, w=None):
        """The stochastic sweep from zero on ``rhs`` with the point draws of
        ``prefix`` (and the low-rank draws ``w`` on a posterior)."""
        bt = rhs + self.sqrtD * noise.eta(prefix, self.idx, rhs.dtype)
        if w is not None:
            bt = bt + torch.einsum("iabc,i->abc", self.B, w)
        y = self.sweep(bt, torch.zeros_like(rhs))
        if self.Bb is not None:
            y = y - torch.einsum("iabc,i->abc", self.Bb, self.bt(y))
        return y


class Chain:
    """The reference chain: levels, coarse factor, and the keyed step.

    ``dtype`` is the arithmetic of every level; the generator's draws are
    made in the configuration's float32, as the program makes them."""

    draw_dtype = torch.float32

    def __init__(self, n, kappa, coarsest_size, dtype, device, obs=None, store=None):
        self.dtype, self.device, self.store = dtype, device, store
        kappa2, hinv2 = float(kappa) ** 2, float((n - 1) ** 2)
        B = sinv = None
        if obs is not None:
            B = ball_columns(n, obs["coords"], obs["radii"], dtype, device)
            sinv = torch.full((B.shape[0],), 1.0 / obs["sigma2"], dtype=dtype, device=device)
        self.levels = [Level(n, kappa2, hinv2, dtype, device, B, sinv)]
        while (n // 2) ** 3 >= coarsest_size and n > 2:
            n, kappa2, hinv2 = n // 2, 8.0 * kappa2, 4.0 * hinv2
            if B is not None:
                B = restrict(B.permute(1, 2, 3, 0)).permute(3, 0, 1, 2).contiguous()
            self.levels.append(Level(n, kappa2, hinv2, dtype, device, B, sinv))
        self.posterior = obs is not None
        self.b = None
        if obs is not None:
            y = torch.as_tensor(np.asarray(obs["values"], float), dtype=dtype, device=device)
            self.b = torch.einsum("iabc,i->abc", self.levels[0].B, sinv * y)
        # the coarsest level's dense precision and its Cholesky factor,
        # factored in at least float32 (the control's lower precisions
        # have no factorization)
        last = self.levels[-1]
        m = last.D.numel()
        fdt = torch.float64 if dtype == torch.float64 else torch.float32
        eye = torch.eye(m, dtype=fdt, device=device).reshape(m, *last.shape)
        A = torch.stack([Level.apply(last, e.to(dtype)).to(fdt).reshape(-1) for e in eye])
        L = torch.linalg.cholesky(0.5 * (A + A.T))
        self.Li = torch.linalg.solve_triangular(L, torch.eye(m, dtype=fdt, device=device), upper=False).to(dtype)

    def _st(self, t):
        """``t`` as the step stores it: rounded to ``store`` when given."""
        return t if self.store is None else t.to(self.store).to(self.dtype)

    @property
    def sqrt_sigma_inv(self):
        return torch.sqrt(self.levels[0].sigma_inv)

    def _lowrank(self, key):
        return self.sqrt_sigma_inv * keys.randn(key, (1, len(self.sqrt_sigma_inv)), self.device,
                                                self.draw_dtype)[0].to(self.dtype)

    def _coarse(self, key, rhs):
        key, sub = keys.split(key)
        eta = keys.randn(sub, (rhs.numel(),), self.device, self.draw_dtype).to(self.dtype)
        return self._st((self.Li.T @ (self.Li @ rhs.reshape(-1) + eta)).reshape(rhs.shape))

    def _tail_ok(self, l) -> bool:
        """Do levels l .. coarsest draw as one keyed call (the program's
        tail: 1 <= l <= L - 2, n2 divides 128, n0 n1 128 <= 128^3)?"""
        n = self.levels[l].shape[0]
        return 1 <= l <= len(self.levels) - 2 and n <= 128 and 128 % n == 0 and n * n * 128 <= 128**3

    def _prior(self, l, rhs, key):
        """Levels l .. coarsest of the prior: the coarse sample, the tail's
        single key, or level l keyed alone."""
        if l == len(self.levels) - 1:
            return self._coarse(key, rhs)
        if self._tail_ok(l):
            return self._tail(l, rhs, key)
        lev = self.levels[l]
        key, k1, k2 = keys.split(key, 3)
        y = self._st(lev.gibbs_from_zero(rhs, noise.hash_prefix(keys.randint31(k1), keys.randint31(k2),
                                                                 noise.CHAIN_DOMAIN)))
        rc = self._st(restrict(rhs - lev.apply(y)))
        key, sub = keys.split(key)
        return self._st(y + prolong(self._prior(l + 1, rc, sub)))

    def _tail(self, l, rhs, key):
        """Levels l .. coarsest of the prior, keyed as one call."""
        key, k1, k2 = keys.split(key, 3)
        seed, step = keys.randint31(k1), keys.randint31(k2)
        ys = []
        for li, lev in enumerate(self.levels[l:-1]):
            y = self._st(lev.gibbs_from_zero(rhs, noise.hash_prefix(seed, step, noise.TAIL_DOMAIN + li)))
            rhs = self._st(restrict(rhs - lev.apply(y)))
            ys.append(y)
        x = self._coarse(key, rhs)
        for y in reversed(ys):
            x = self._st(y + prolong(x))
        return x

    def _general(self, l, rhs, key):
        """Levels l .. coarsest of the posterior, each sweep keyed alone."""
        if l == len(self.levels) - 1:
            return self._coarse(key, rhs)
        lev = self.levels[l]
        key, k1, k2 = keys.split(key, 3)
        seed, extra = keys.randint31(k1), keys.randint31(k2)
        key, klr = keys.split(key)
        y = self._st(lev.gibbs_from_zero(rhs, noise.hash_prefix(seed, extra * 2, noise.SWEEP_DOMAIN),
                                         self._lowrank(klr)))
        key, sub = keys.split(key)
        rc = self._st(restrict(rhs - lev.apply(y)))
        return self._st(y + prolong(self._general(l + 1, rc, sub)))

    def step(self, key: int, x):
        """(key', x'): one chain step from ``x`` under ``key``."""
        key, sub = keys.split(key)
        w = None
        if self.posterior:
            sub, klr = keys.split(sub)
            w = self._lowrank(klr)
        sub, k1, k2 = keys.split(sub, 3)
        lev = self.levels[0]
        r = -lev.apply(x) if self.b is None else self._st(self.b) - lev.apply(x)
        y = lev.gibbs_from_zero(r, noise.hash_prefix(keys.randint31(k1), keys.randint31(k2),
                                                      noise.CHAIN_DOMAIN), w)
        rc = self._st(restrict(r - lev.apply(y)))
        sub, sub2 = keys.split(sub)
        z = self._general(1, rc, sub2) if self.posterior else self._prior(1, rc, sub2)
        return key, self._st(self._st(x + y) + prolong(z))

    def follow(self, key: int, x, n_steps: int):
        """(x_final, qoi (n_steps,)): ``n_steps`` steps from ``x``, the
        field mean after each."""
        x = self._st(x.to(self.dtype))
        q = []
        for _ in range(n_steps):
            key, x = self.step(key, x)
            q.append(x.mean())
        return x, torch.stack(q)
