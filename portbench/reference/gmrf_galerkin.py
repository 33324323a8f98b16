"""Plain-torch reference of the linear-Galerkin MGMC chain step on a 3D GMRF.

The configuration: the 7-point shifted Laplacian in link-count form on an
n^3 grid of [0, 1]^3 (:mod:`.gmrf`'s level 0), and the geometric hierarchy
of upstream's ``PCMG`` with ``-pc_mg_galerkin both``:

* each coarse grid keeps ceil(m/2) points an axis (vertex-style: coarse
  node i is fine node 2i), halving while the coarse grid keeps
  ``coarsest_size`` points and every extent is above 2;
* the prolongation P is trilinear, axis by axis: fine node 2i takes coarse
  node i, fine node 2i + 1 the mean of coarse nodes i and i + 1; on an
  even extent the last fine node takes the last coarse node whole.
  Restriction is P^T;
* every coarse operator is the exact product A_c = P^T A P, a 27-point
  stencil with coefficient fields, read off 27 comb probes: impulses three
  nodes apart never share a row, so the response of the comb of phase p
  at node j is A_c[j, j + o] for the offset o with (j + o) mod 3 = p.

A chain step is x <- x + M(b - A x), M the V(n_pre, n_post) cycle from
zero: at each level above the coarsest n_pre forward Gibbs sweeps, the
residual restricted by P^T, the coarse correction prolonged, n_post
forward sweeps; an exact Cholesky sample at the coarsest.  A sweep
targets N(A^{-1} rhs, A^{-1}) with b~ = rhs + sqrt((2 - omega)/omega)
sqrt(D) eta: at level 0 red/black by (i + j + k) % 2, red first; below,
8 colours c = 4 (i % 2) + 2 (j % 2) + (k % 2) in order, each colour's
points updated at once (no two of them couple).  Every sweep's draws come
from a (seed, step) pair of its key, counter-hashed under
:data:`.noise.SWEEP_DOMAIN` at level 0 and :data:`GALERKIN_DOMAIN` below;
the coarse sample's from the generator of its key (the program's
published conventions, :mod:`.keys`, :mod:`.noise`).  Nothing here reads
what the program built.

Departures from upstream ParMGMC (``src/pc_gamgmc.c``): its ``sorgibbs``
smoothers sweep each process's rows in PETSc's SOR order, here the parity
colourings the program uses (the same chain law); its draws come from
PETSc's generator, here the counter hash and ``torch.Generator``; its
``PCMG`` cycle is V(1,1) by default, here the configuration's (V(2,2),
the program's README quick start); its coarse Cholesky factors a sparse
matrix, here the dense one.

The arithmetic runs in the precision the caller names (float64 for the
reference), the generator's draws in float32 as the program makes them.
The control (``store=torch.bfloat16``) computes in float32 and rounds
every field a step stores -- the state, each sweep, the right-hand side,
the restricted residual, the coarse sample, each prolonged sum -- to
bfloat16, as a kernel that kept its fields in bfloat16 would.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from portbench.reference import keys, noise
from portbench.reference.gmrf import _links, _neigh_sum

# the program's noise domain of the 8-colour sweeps (a frozen copy)
GALERKIN_DOMAIN = 0x3C6EF372
OFFSETS = tuple(o for o in itertools.product((-1, 0, 1), repeat=3) if any(o))


def coarse_extent(m: int) -> int:
    return (m + 1) // 2


def extents(n: int, coarsest_size: int) -> list:
    """The hierarchy's extents from n: halve while the coarse grid keeps
    ``coarsest_size`` points and every extent is above 2."""
    out = [n]
    while coarse_extent(out[-1]) ** 3 >= coarsest_size and out[-1] > 2:
        out.append(coarse_extent(out[-1]))
    return out


def prolongation_1d(nf: int, dtype, device) -> torch.Tensor:
    """(nf, ceil(nf/2)): linear interpolation along one axis."""
    nc = coarse_extent(nf)
    P = torch.zeros(nf, nc, dtype=dtype, device=device)
    for i in range(nc):
        P[2 * i, i] = 1.0
        if 2 * i + 1 < nf:
            if i + 1 < nc:
                P[2 * i + 1, i] = P[2 * i + 1, i + 1] = 0.5
            else:  # an even extent's last fine node
                P[2 * i + 1, i] = 1.0
    return P


def along(M, v, axis):
    """M applied along ``axis`` of the 3D field v."""
    return torch.movedim(torch.tensordot(M, torch.movedim(v, axis, 0), dims=1), 0, axis)


def _window(v, o):
    """The view of the 1-padded field v holding x[i + o] at index i."""
    n0, n1, n2 = (s - 2 for s in v.shape)
    return v[1 + o[0]:1 + o[0] + n0, 1 + o[1]:1 + o[1] + n1, 1 + o[2]:1 + o[2] + n2]


class Stencil:
    """A 27-point operator: ``coef[o]`` the field of each offset (zero
    where the neighbour is outside the grid) and the diagonal ``D``."""

    def __init__(self, coef: dict, D):
        self.coef, self.D = coef, D
        self.shape = tuple(D.shape)

    def offdiag(self, x):
        xp = F.pad(x[None, None], (1, 1, 1, 1, 1, 1))[0, 0]
        return sum(c * _window(xp, o) for o, c in self.coef.items())

    def apply(self, x):
        return self.D * x + self.offdiag(x)

    def colour_sweep(self, bt, x, omega):
        """One forward 8-colour sweep on the right-hand side ``bt``, in a
        zero-padded copy of x."""
        xp = F.pad(x[None, None], (1, 1, 1, 1, 1, 1))[0, 0]
        for c in range(8):
            p = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
            cnt = [len(range(q, m, 2)) for q, m in zip(p, self.shape)]
            own = tuple(slice(q, None, 2) for q in p)

            def at(o):  # the colour's points shifted by o, in xp
                return xp[tuple(slice(1 + q + oo, 1 + q + oo + 2 * m, 2) for q, oo, m in zip(p, o, cnt))]

            nb = sum(cf[own] * at(o) for o, cf in self.coef.items())
            here = at((0, 0, 0))
            here.copy_((1.0 - omega) * here + omega * (bt[own] - nb) / self.D[own])
        return xp[1:-1, 1:-1, 1:-1].contiguous()


class FD:
    """Level 0: the link-count 7-point operator."""

    def __init__(self, n, kappa2, hinv2, dtype, device):
        self.shape = (n, n, n)
        self.hinv2 = hinv2
        self.D = kappa2 + hinv2 * _links(self.shape, dtype, device)
        i = torch.arange(n, device=device)
        self.par = (i[:, None, None] + i[None, :, None] + i[None, None, :]) % 2

    def apply(self, x):
        return self.D * x - self.hinv2 * _neigh_sum(x)

    def colour_sweep(self, bt, x, omega):
        """One forward red/black sweep on the right-hand side ``bt``."""
        for color in (0, 1):
            upd = (1.0 - omega) * x + omega * (bt + self.hinv2 * _neigh_sum(x)) / self.D
            x = torch.where(self.par == color, upd, x)
        return x


def galerkin(op, P1, nc: int) -> Stencil:
    """P^T A P of ``op`` read off the 27 comb probes of spacing 3 (P1: the
    1D prolongation of every axis)."""
    dev, dt = op.D.device, op.D.dtype
    i = torch.arange(nc, device=dev)
    U = []
    for phase in itertools.product(range(3), repeat=3):
        comb = torch.ones((nc,) * 3, dtype=dt, device=dev)
        for ax, p in enumerate(phase):
            view = [1, 1, 1]
            view[ax] = nc
            comb = comb * (i % 3 == p).to(dt).reshape(view)
        v = comb
        for ax in range(3):
            v = along(P1, v, ax)
        u = op.apply(v)
        for ax in range(3):
            u = along(P1.T, u, ax)
        U.append(u)
    U = torch.stack(U)
    ii, jj, kk = torch.meshgrid(i, i, i, indexing="ij")
    out = {}
    for o in ((0, 0, 0),) + OFFSETS:
        code = ((ii + o[0]) % 3) * 9 + ((jj + o[1]) % 3) * 3 + (kk + o[2]) % 3
        out[o] = U.gather(0, code[None])[0]
    D = out.pop((0, 0, 0))
    return Stencil(out, D)


class Chain:
    """The reference chain: levels, transfers, coarse factor, the keyed step.

    ``dtype`` is the arithmetic of every level; the generator's draws are
    made in the configuration's float32, as the program makes them."""

    draw_dtype = torch.float32

    def __init__(self, n, kappa, coarsest_size, n_pre, n_post, omega, dtype, device, store=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype, self.device, self.store = dtype, device, store
        self.n_pre, self.n_post, self.omega = int(n_pre), int(n_post), float(omega)
        self.nfac = ((2.0 - self.omega) / self.omega) ** 0.5
        ext = extents(int(n), int(coarsest_size))
        # the hierarchy in float64 at least, then in the arithmetic's precision
        bdt = torch.float64
        self.P = [prolongation_1d(m, bdt, device) for m in ext[:-1]]
        levels = [FD(ext[0], float(kappa) ** 2, float((n - 1) ** 2), bdt, device)]
        for l, m in enumerate(ext[1:]):
            levels.append(galerkin(levels[-1], self.P[l], m))
        last = levels[-1]
        mm = last.D.numel()
        eye = torch.eye(mm, dtype=bdt, device=device).reshape(mm, *last.shape)
        A = torch.stack([last.apply(e).reshape(-1) for e in eye])
        L = torch.linalg.cholesky(0.5 * (A + A.T))
        fdt = torch.float64 if dtype == torch.float64 else torch.float32
        self.Li = torch.linalg.solve_triangular(L, torch.eye(mm, dtype=bdt, device=device),
                                                upper=False).to(fdt).to(dtype)
        self.levels = [self._cast(lv) for lv in levels[:-1]] + [None]
        self.P = [p.to(dtype) for p in self.P]
        self.coarse_shape = last.shape
        self.idx = [torch.arange(m**3, device=device, dtype=torch.int64).reshape((m,) * 3) for m in ext]

    def _cast(self, lv):
        if isinstance(lv, FD):
            lv.D = lv.D.to(self.dtype)
            return lv
        return Stencil({o: c.to(self.dtype) for o, c in lv.coef.items()}, lv.D.to(self.dtype))

    def _st(self, t):
        """``t`` as the step stores it: rounded to ``store`` when given."""
        return t if self.store is None else t.to(self.store).to(self.dtype)

    def restrict(self, l, v):
        for ax in range(3):
            v = along(self.P[l].T, v, ax)
        return v

    def prolong(self, l, v):
        for ax in range(3):
            v = along(self.P[l], v, ax)
        return v

    def _sweep(self, l, rhs, y, key):
        key, k1, k2 = keys.split(key, 3)
        domain = noise.SWEEP_DOMAIN if l == 0 else GALERKIN_DOMAIN
        prefix = noise.hash_prefix(keys.randint31(k1), keys.randint31(k2) * 2, domain)
        lv = self.levels[l]
        bt = rhs + self.nfac * torch.sqrt(lv.D) * noise.eta(prefix, self.idx[l], rhs.dtype)
        return key, self._st(lv.colour_sweep(bt, y, self.omega))

    def _coarse(self, key, rhs):
        key, sub = keys.split(key)
        eta = keys.randn(sub, (rhs.numel(),), self.device, self.draw_dtype).to(self.dtype)
        return self._st((self.Li.T @ (self.Li @ rhs.reshape(-1) + eta)).reshape(rhs.shape))

    def cycle(self, l, rhs, key):
        """The V-cycle from zero at level l on ``rhs`` under ``key``."""
        if self.levels[l] is None:
            return self._coarse(key, rhs)
        y = torch.zeros_like(rhs)
        for _ in range(self.n_pre):
            key, y = self._sweep(l, rhs, y, key)
        key, sub = keys.split(key)
        rc = self._st(self.restrict(l, rhs - self.levels[l].apply(y)))
        y = self._st(y + self.prolong(l, self.cycle(l + 1, rc, sub)))
        for _ in range(self.n_post):
            key, y = self._sweep(l, rhs, y, key)
        return y

    def step(self, key: int, x):
        """(key', x'): one chain step of the prior (b = 0) from ``x``."""
        key, sub = keys.split(key)
        r = self._st(-self.levels[0].apply(x))
        return key, self._st(x + self.cycle(0, r, sub))

    def follow(self, key: int, x, n_steps: int):
        """(x_final, qoi (n_steps,)): ``n_steps`` steps from ``x``, the
        field mean after each."""
        x = self._st(x.to(self.dtype))
        q = []
        for _ in range(n_steps):
            key, x = self.step(key, x)
            q.append(x.mean())
        return x, torch.stack(q)
