"""Plain reference of the MGMC chain step on a P1 Matérn field over an
unstructured mesh, conditioned on ball averages.

The configuration: a Gmsh mesh refined uniformly (a triangle into four),
the P1 precision A = kappa^2 M + K (consistent mass M, stiffness K), and
observations y_i = the ball average of the field over ball i with noise
variance sigma2: B[:, i] = M 1_ball_i / |ball_i|, posterior precision
A + B Sigma^{-1} B^T, right-hand side f = B Sigma^{-1} y.  The hierarchy is
smoothed aggregation (strength theta = 0.02, greedy aggregates, one
Jacobi smoothing of the tentative prolongator with omega = 2/3, Galerkin
A_c = P^T A P) down to ``coarsest_size`` unknowns.  A chain step is

    x <- x + M_mg(b - A x)

with a V(1,1) cycle of forward multicolour Gibbs sweeps (omega = 1),
an exact Cholesky sample at the coarsest level, and on every level the
low-rank noise B w and the Woodbury correction y <- y - Bb (B^T y).

The program orders each level's unknowns by the colours of a greedy
distance-1 colouring (rows by descending degree within a colour) and
draws its noise in that order, one generator a keyed sweep; the
reference works the same orderings out again from the mesh, with frozen
copies of the published rules below, and draws the same numbers from the
same keys.  Every sparse product and sweep is its own (scipy on the
host for set-up, torch on the device for the steps).  Nothing here reads
what the program built.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from portbench.reference import keys


# -- the mesh, P1 assembly, observations --------------------------------------

def read_gmsh(path):
    """(points (n, d), cells (m, d + 1)) of a Gmsh 4.1 ASCII file: the
    highest-dimensional simplices, nodes renumbered in tag order."""
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0

    def until(tag):
        nonlocal i
        while lines[i].strip() != tag:
            i += 1
        i += 1

    until("$Nodes")
    head = lines[i].split()
    i += 1
    coords = np.zeros((int(head[3]) + 1, 3))
    for _ in range(int(head[0])):
        nb = int(lines[i].split()[3])
        i += 1
        tags = [int(lines[i + k]) for k in range(nb)]
        i += nb
        for k in range(nb):
            coords[tags[k]] = [float(v) for v in lines[i + k].split()[:3]]
        i += nb
    until("$Elements")
    nblocks = int(lines[i].split()[0])
    i += 1
    tris, tets = [], []
    for _ in range(nblocks):
        bh = lines[i].split()
        i += 1
        etype, nb = int(bh[2]), int(bh[3])
        for k in range(nb):
            parts = lines[i + k].split()
            if etype == 2:
                tris.append([int(p) for p in parts[1:4]])
            elif etype == 4:
                tets.append([int(p) for p in parts[1:5]])
        i += nb
    cells, dim = (np.asarray(tets), 3) if tets else (np.asarray(tris), 2)
    used = np.unique(cells)
    remap = np.full(coords.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    return coords[used][:, :dim], remap[cells]


def refine(points, cells):
    """Uniform refinement: a triangle into four (edge midpoints numbered
    after the old nodes in order of first use), a tetrahedron into eight."""
    mids, pts = {}, list(points)

    def mid(a, b):
        k = (min(a, b), max(a, b))
        if k not in mids:
            mids[k] = len(pts)
            pts.append(0.5 * (points[a] + points[b]))
        return mids[k]

    out = []
    if cells.shape[1] == 3:
        for a, b, c in cells:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    else:
        for a, b, c, d in cells:
            ab, ac, ad, bc, bd, cd = mid(a, b), mid(a, c), mid(a, d), mid(b, c), mid(b, d), mid(c, d)
            out += [[a, ab, ac, ad], [b, ab, bc, bd], [c, ac, bc, cd], [d, ad, bd, cd],
                    [ab, ac, ad, cd], [ab, ac, bc, cd], [ab, bc, bd, cd], [ab, ad, bd, cd]]
    return np.asarray(pts), np.asarray(out)


def p1_matrices(points, cells):
    """(K, M): P1 stiffness and consistent mass, scipy CSR."""
    d = points.shape[1]
    X = points[cells]
    T = np.transpose(X[:, 1:] - X[:, :1], (0, 2, 1))
    vol = np.abs(np.linalg.det(T)) / math.factorial(d)
    Ti = np.linalg.inv(T)
    G = np.concatenate([-Ti.sum(axis=1, keepdims=True), Ti], axis=1)
    Ke = np.einsum("eid,ejd,e->eij", G, G, vol)
    Me = vol[:, None, None] * (np.ones((d + 1, d + 1)) + np.eye(d + 1))[None] / ((d + 1) * (d + 2))
    rows = np.repeat(cells, d + 1, axis=1).ravel()
    cols = np.tile(cells, (1, d + 1)).ravel()
    n = points.shape[0]
    K = sp.csr_matrix((Ke.ravel(), (rows, cols)), shape=(n, n))
    M = sp.csr_matrix((Me.ravel(), (rows, cols)), shape=(n, n))
    K.sum_duplicates()
    M.sum_duplicates()
    return K, M


def observation_columns(points, M, coords, radii):
    """(n, k): column i = M (1_ball_i / |ball_i|), original node order."""
    d = points.shape[1]
    cols = []
    for c, r in zip(np.asarray(coords, float), np.asarray(radii, float)):
        vol = math.pi * r * r if d == 2 else 4.0 * math.pi / 3.0 * r**3
        cols.append(M @ ((((points - c[:d]) ** 2).sum(axis=1) < r * r).astype(float) / vol))
    return np.stack(cols, axis=-1)


def region_weights(points, lo, hi):
    """Weights of the mean over the box [lo, hi] (original order)."""
    d = points.shape[1]
    m = np.all((points >= np.asarray(lo, float)[:d]) & (points <= np.asarray(hi, float)[:d]), axis=1)
    return m / m.sum()


# -- orderings and the aggregation hierarchy ----------------------------------

def colour_order(A):
    """(perm, colour starts) of a symmetric CSR matrix: greedy distance-1
    colours in natural order, colours contiguous, rows by descending
    off-diagonal degree (stable) within a colour; internal[i] = orig[perm[i]]."""
    n = A.shape[0]
    colours = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        used = set(colours[A.indices[A.indptr[i]:A.indptr[i + 1]]].tolist())
        c = 0
        while c in used:
            c += 1
        colours[i] = c
    nc = int(colours.max()) + 1
    perm = np.argsort(colours, kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.bincount(colours, minlength=nc))]).astype(int)
    off = A - sp.diags(A.diagonal())
    off.eliminate_zeros()
    deg = np.diff(off.tocsr().indptr)
    order = np.concatenate([starts[c] + np.argsort(-deg[perm[starts[c]:starts[c + 1]]], kind="stable")
                            for c in range(nc)])
    return perm[order], starts


def _aggregate(S):
    """Greedy aggregation of the strength graph: roots whose neighbours
    are all free take them; stragglers join an aggregated neighbour or
    start their own."""
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    k = 0
    for i in range(n):
        nb = S.indices[S.indptr[i]:S.indptr[i + 1]]
        if agg[i] < 0 and np.all(agg[nb] < 0):
            agg[i] = k
            agg[nb] = k
            k += 1
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = S.indices[S.indptr[i]:S.indptr[i + 1]]
        hit = nb[agg[nb] >= 0]
        if hit.size:
            agg[i] = agg[hit[0]]
        else:
            agg[i] = k
            k += 1
    return agg, k


def coarsen(A, theta=0.02, omega=2.0 / 3.0):
    """(P, A_c): one smoothed-aggregation level of the CSR matrix A."""
    n = A.shape[0]
    d = np.sqrt(np.maximum(A.diagonal(), 1e-300))
    C = sp.csr_matrix(A, copy=True)
    C.setdiag(0.0)
    C.eliminate_zeros()
    coo = C.tocoo()
    keep = np.abs(coo.data) > theta * d[coo.row] * d[coo.col]
    S = sp.csr_matrix((np.ones(keep.sum()), (coo.row[keep], coo.col[keep])), shape=A.shape)
    agg, k = _aggregate(S)
    P = sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, k))
    P = sp.csr_matrix((sp.eye(n) - omega * (sp.diags(1.0 / A.diagonal()) @ A)) @ P)
    Ac = sp.csr_matrix(P.T @ A @ P)
    Ac.eliminate_zeros()
    return P, Ac


def ell_csr(Ap):
    """The matrix the program's aggregation starts from: the operator's
    padded rows (off-diagonals in row order, pads of value 0 at the row's
    own column) assembled again, then the diagonal set and zeros dropped."""
    n = Ap.shape[0]
    diag = Ap.diagonal().copy()
    off = sp.csr_matrix(Ap - sp.diags(diag))
    off.eliminate_zeros()
    w = max(1, int(np.diff(off.indptr).max()))
    vals = np.zeros((n, w))
    cols = np.tile(np.arange(n)[:, None], (1, w))
    for i in range(n):
        lo, hi = off.indptr[i], off.indptr[i + 1]
        vals[i, :hi - lo] = off.data[lo:hi]
        cols[i, :hi - lo] = off.indices[lo:hi]
    A = sp.csr_matrix((vals.ravel(), (np.repeat(np.arange(n), w), cols.ravel())), shape=(n, n))
    A.setdiag(diag)
    A.eliminate_zeros()
    return A


def _dev(M, dtype, device):
    M = sp.csr_matrix(M)
    with warnings.catch_warnings():  # torch calls its sparse CSR support beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(torch.as_tensor(M.indptr, dtype=torch.int64),
                                       torch.as_tensor(M.indices, dtype=torch.int64),
                                       torch.as_tensor(M.data), size=M.shape).to(device=device, dtype=dtype)


class Level:
    """One level in its internal order: colour blocks of the off-diagonal
    part, the diagonal, B and the Woodbury factor of the forward sweep."""

    def __init__(self, A, starts, B, sigma_inv, dtype, device):
        self.n = A.shape[0]
        self.dtype = dtype
        diag = A.diagonal().copy()
        off = sp.csr_matrix(A - sp.diags(diag))
        off.eliminate_zeros()
        self.diag = torch.as_tensor(diag).to(device=device, dtype=dtype)
        self.A = _dev(A, dtype, device)
        self.blocks = [(int(s), int(e), _dev(off[s:e], dtype, device))
                       for s, e in zip(starts[:-1], starts[1:]) if e > s]
        self.B = torch.as_tensor(B).to(device=device, dtype=dtype)
        self.sigma_inv = torch.as_tensor(sigma_inv).to(device=device, dtype=dtype)
        C = self.sweep(self.B, torch.zeros_like(self.B))
        small = torch.diag(1.0 / self.sigma_inv) + self.B.T @ C
        self.Bb = C @ torch.linalg.inv(small.double()).to(dtype)

    @staticmethod
    def _mm(M, x):
        return (M @ x[:, None])[:, 0] if x.ndim == 1 else M @ x

    def apply(self, x):
        """(A + B Sigma^{-1} B^T) x; x is (n,) or (n, C)."""
        si = self.sigma_inv if x.ndim == 1 else self.sigma_inv[:, None]
        return self._mm(self.A, x) + self.B @ (si * (self.B.T @ x))

    def sweep(self, b, x):
        """One forward multicolour Gauss-Seidel sweep (omega = 1) of the
        base operator, colour block by colour block."""
        x = x.clone()
        for s, e, off in self.blocks:
            d = self.diag[s:e] if x.ndim == 1 else self.diag[s:e, None]
            x[s:e] = (b[s:e] - self._mm(off, x)) / d
        return x


class Chain:
    """The reference chain of a mesh configuration; x in internal order,
    (n,) or chain-major (n, C).  The generator's draws are made in the
    configuration's float64, as the program makes them."""

    draw_dtype = torch.float64

    def __init__(self, mesh_path, refinements, kappa, obs, qoi, coarsest_size, dtype, device):
        self.dtype, self.device = dtype, device
        points, cells = read_gmsh(mesh_path)
        for _ in range(refinements):
            points, cells = refine(points, cells)
        K, M = p1_matrices(points, cells)
        A = sp.csr_matrix(kappa**2 * M + K)
        B = observation_columns(points, M, obs["coords"], obs["radii"])
        sigma_inv = np.full(B.shape[1], 1.0 / obs["sigma2"])
        f = B @ (sigma_inv * np.asarray(obs["values"], float))
        w = region_weights(points, qoi[0], qoi[1])
        perm, starts = colour_order(A)
        Ap = A[perm][:, perm].tocsr()
        B, f, w = B[perm], f[perm], w[perm]
        self.b = torch.as_tensor(f).to(device=device, dtype=dtype)
        self.w = torch.as_tensor(w).to(device=device, dtype=dtype)
        self.levels, self.P = [Level(Ap, starts, B, sigma_inv, dtype, device)], []
        A = ell_csr(Ap)
        while A.shape[0] > coarsest_size:
            P, Ac = coarsen(A)
            if Ac.shape[0] >= A.shape[0]:
                break
            pc, starts = colour_order(Ac)
            P = sp.csr_matrix(P[:, pc])
            B = P.T @ B
            self.P.append(_dev(P, dtype, device))
            self.levels.append(Level(Ac[pc][:, pc].tocsr(), starts, B, sigma_inv, dtype, device))
            A = sp.csr_matrix(Ac[pc][:, pc])
        last = self.levels[-1]
        dense = last.A.to_dense().double() + (last.B.double() * last.sigma_inv.double()) @ last.B.double().T
        L = torch.linalg.cholesky(dense)
        self.Li = torch.linalg.solve_triangular(L, torch.eye(L.shape[0], dtype=L.dtype, device=device),
                                                upper=False).to(dtype)
        self.Pt = [P.transpose(0, 1).to_sparse_csr() for P in self.P]

    def _gibbs(self, l, key, x, b):
        lev = self.levels[l]
        key, sub = keys.split(key)
        g = keys.generator(sub, self.device)
        shape = tuple(x.shape)
        eta = torch.randn(shape, generator=g, dtype=self.draw_dtype, device=self.device).to(self.dtype)
        eta_lr = torch.randn((lev.B.shape[1], *shape[1:]), generator=g, dtype=self.draw_dtype,
                             device=self.device).to(self.dtype)
        sqd = torch.sqrt(lev.diag) if x.ndim == 1 else torch.sqrt(lev.diag)[:, None]
        ssi = torch.sqrt(lev.sigma_inv) if x.ndim == 1 else torch.sqrt(lev.sigma_inv)[:, None]
        bt = (b if b.ndim == x.ndim else b[:, None]) + sqd * eta + lev.B @ (ssi * eta_lr)
        y = lev.sweep(bt, x)
        return key, y - lev.Bb @ (lev.B.T @ y)

    def _cycle(self, l, b, key):
        if l == len(self.levels) - 1:
            key, sub = keys.split(key)
            eta = torch.randn(tuple(b.shape), generator=keys.generator(sub, self.device),
                              dtype=self.draw_dtype, device=self.device).to(self.dtype)
            return self.Li.T @ (self.Li @ b + eta)
        x = torch.zeros_like(b)
        key, x = self._gibbs(l, key, x, b)
        key, sub = keys.split(key)
        r = Level._mm(self.Pt[l], b - self.levels[l].apply(x))
        x = x + Level._mm(self.P[l], self._cycle(l + 1, r, sub))
        key, x = self._gibbs(l, key, x, b)
        return x

    def step(self, key, x):
        key, sub = keys.split(key)
        b = self.b if x.ndim == 1 else self.b[:, None].expand_as(x)
        return key, x + self._cycle(0, b - self.levels[0].apply(x), sub)

    def follow(self, key, x, n_steps):
        """(x_final, qoi (C, n_steps) or (n_steps,))."""
        x = x.to(self.dtype)
        q = []
        for _ in range(n_steps):
            key, x = self.step(key, x)
            q.append(self.w @ x)
        return x, torch.stack(q, dim=-1)
