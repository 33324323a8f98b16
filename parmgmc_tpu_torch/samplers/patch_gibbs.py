"""Vertex-star patch (block-)Gibbs sampler (port of ``PatchGibbsSampler``
and ``detect_squared_fd`` in ``parmgmc_tpu.samplers.patch_gibbs``).

The smoother of choice for squared-operator (Matern-type) priors, where
point Gibbs mixes poorly: patch S, a node and its 2d unit neighbours, is
resampled from its exact conditional

    x_S ~ N(A_SS^{-1} (b_S - A_{S,rest} x_rest), A_SS^{-1})

patch by patch.  Patches are coloured by their centres' residues mod
(radius + 3) on every axis, so same-colour patches are uncoupled and one
colour pass updates all of them at once; a sweep is the (radius + 3)^d
colours in order, axis 0 the most significant digit.

``step_with_noise(x, b, noises)`` is the plain colour sweep for any
dimension, radius and scalar or field coefficients, with explicit N(0, 1)
draws ``eta`` of shape (k, *grid) (member j of the patch centred at p
takes ``eta[j][p]``): the oracle side of the tests and the body of the
explicit-noise chains.  Each colour's patch matrices and their unrolled
structure-of-arrays Cholesky factors depend on the operator alone; they
are built at the first call and kept.  The keyed ``step`` runs the patch
sweep kernels (:func:`~parmgmc_tpu_torch.kernels.patch_sweep.
fused_patch_sweep_sqfd`) when ``create`` found a 3D float32 squared FD
operator, and the explicit-noise step with a ``torch.Generator`` draw
otherwise.

:class:`GraphPatchGibbsSampler` is the same smoother on an unstructured
:class:`~parmgmc_tpu_torch.operators.graph.GraphOperator`: vertex-star
patches, a distance-4 colouring, and batched Cholesky factors of each
colour's patch matrices (no kernel; plain torch).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.kernels._twin import f32
from parmgmc_tpu_torch.kernels.patch_sweep import fused_patch_sweep_sqfd
from parmgmc_tpu_torch.operators.stencil import (
    StencilOperator,
    fd_stencil,
    star_offsets,
)
from parmgmc_tpu_torch.samplers.gibbs import _draw, per_chain, refuse_batch, with_batch

__all__ = ["PatchGibbsSampler", "GraphPatchGibbsSampler", "detect_squared_fd", "star_patch"]


def star_patch(d: int) -> tuple:
    """The vertex-star member offsets, centre first."""
    return ((0,) * d,) + star_offsets(d)


def detect_squared_fd(op: StencilOperator) -> "tuple | None":
    """(kappa2, hinv2) of F, rounded to float32, if ``op`` is F^2 for the
    link-count FD operator F = kappa2 + hinv2 * links on a 3D grid; else
    None.  The (0, 0, 2) coefficient of F^2 is hinv2^2 and an interior
    diagonal is (kappa2 + 6 hinv2)^2 + 6 hinv2^2; the candidate is then
    checked by probing ``op.apply`` against F(F v) on a seeded random v.
    Reads the device (set-up time)."""
    if op.ndim != 3 or op.radius != 2:
        return None
    c2 = dict(zip(op.offsets, op.coeffs)).get((0, 0, 2))
    if c2 is None or c2.ndim != 0 or float(c2) <= 0:
        return None
    h2 = math.sqrt(float(c2))
    ctr = tuple(s // 2 for s in op.grid_shape)
    dint = float(op.diag[ctr]) - 6.0 * h2 * h2
    if dint <= 0:
        return None
    k2 = math.sqrt(dint) - 6.0 * h2
    if k2 <= 0:
        return None
    Fop = fd_stencil(op.grid_shape, k2, h2, dtype=op.dtype, device=op.device, lazy=False)
    g = torch.Generator(device=op.device).manual_seed(0)
    v = torch.randn(op.grid_shape, generator=g, dtype=op.dtype, device=op.device)
    want = op.apply(v)
    rel = float((want - Fop.apply(Fop.apply(v))).abs().max() / want.abs().max())
    if rel > 1e-5:
        return None
    return (f32(k2), f32(h2))


@dataclass(frozen=True, eq=False)
class PatchGibbsSampler:
    """Coloured vertex-star block-Gibbs sweep for N(A^{-1} b, A^{-1})."""

    base: StencilOperator
    patch_offsets: tuple  # k member offsets, centre first
    ncolor_base: int  # colours = ncolor_base ** ndim
    sq_fd_params: "tuple | None" = None  # (kappa2, hinv2) of F when A = F^2
    # "kernel": the keyed step runs the patch kernels where they apply;
    # "torch": always the explicit-noise step (registry.lax_variant)
    impl: str = "kernel"
    # the explicit-noise step's per-colour tables, built at its first call
    _plain: dict = field(default_factory=dict, init=False, repr=False)

    @staticmethod
    def create(op: StencilOperator) -> "PatchGibbsSampler":
        if not isinstance(op, StencilOperator):
            raise TypeError("PatchGibbsSampler needs a StencilOperator")
        sq = detect_squared_fd(op) if op.dtype == torch.float32 else None
        return PatchGibbsSampler(
            base=op, patch_offsets=star_patch(op.ndim), ncolor_base=op.radius + 3,
            sq_fd_params=sq,
        )

    @property
    def grid_shape(self):
        return self.base.grid_shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    @property
    def has_kernel(self) -> bool:
        """Does the keyed step run the patch kernels?"""
        return self.impl == "kernel" and self.sq_fd_params is not None

    @property
    def route(self) -> str:
        """The keyed step's route: the patch kernel's wrapper, or torch."""
        return "fused_patch_sweep_sqfd" if self.has_kernel else "torch"

    def noise_shapes(self):
        return [{"eta": (len(self.patch_offsets), *self.grid_shape)}]

    def prepare(self, b):
        return None

    # -- the explicit-noise sweep --------------------------------------------
    def _tables(self):
        """The explicit-noise sweep's tables, built at its first call.  Per
        colour: the member flat indices in (centre, member) order, with
        members outside the grid sent to a zero slot (index n, ``idx``)
        or to 0 (``ridx``, for the residual, whose value there is
        masked); the in-grid masks (nc, k, 1); the patch matrices A_SS and
        the inverses of their Cholesky factors (nc, k, k).  Also the
        centres of all colours in sweep order (every point once), the
        off-diagonal coefficients stacked as (*grid, noff) and each
        offset's position in the (2 radius + 1)^d window."""
        if self._plain:
            return self._plain
        op, shape, m = self.base, self.grid_shape, self.ncolor_base
        d, n, dt, dev = op.ndim, op.n, op.dtype, op.device
        k = len(self.patch_offsets)
        coeff_map = dict(zip(op.offsets, op.coeffs))

        def ext(v):  # grid field as a flat vector with the zero slot
            return torch.cat([v.reshape(-1), v.new_zeros(1)])

        diag_e = ext(op.diag)
        coeff_e = {o: ext(c) if c.ndim else c for o, c in coeff_map.items()}
        colours = []
        for c in range(m**d):
            a = [(c // m ** (d - 1 - ax)) % m for ax in range(d)]
            axes = [torch.arange(ai, s, m, device=dev) for ai, s in zip(a, shape)]
            if any(len(t) == 0 for t in axes):
                continue
            ctr = torch.stack(torch.meshgrid(*axes, indexing="ij")).reshape(d, -1)
            idx, mask = [], []
            for o in self.patch_offsets:
                p = ctr + torch.tensor(o, device=dev).reshape(d, 1)
                ok = torch.ones(p.shape[1], dtype=torch.bool, device=dev)
                flat = torch.zeros(p.shape[1], dtype=torch.int64, device=dev)
                for ax in range(d):
                    ok &= (p[ax] >= 0) & (p[ax] < shape[ax])
                    flat = flat * shape[ax] + p[ax]
                idx.append(torch.where(ok, flat, n))
                mask.append(ok.to(dt))
            idx, mask = torch.stack(idx), torch.stack(mask)  # (k, nc)

            def ass(i, j):
                """A_SS entry (i, j), j <= i, from row i's coefficients
                (None: a structural zero)."""
                if i == j:
                    return diag_e[idx[i]] * mask[i] + (1.0 - mask[i])
                rel = tuple(q - w for w, q in zip(self.patch_offsets[i], self.patch_offsets[j]))
                if rel not in coeff_map:
                    return None
                cf = coeff_e[rel]
                return (cf[idx[i]] if cf.ndim else cf) * mask[i] * mask[j]

            zero = torch.zeros(idx.shape[1], dtype=dt, device=dev)
            A = [[ass(i, j) for j in range(i + 1)] for i in range(k)]
            A = [[zero if e is None else e for e in row] for row in A]
            Lf = [[None] * k for _ in range(k)]
            for i in range(k):  # unrolled Cholesky-Banachiewicz over the patch
                for j in range(i + 1):
                    s = A[i][j]
                    for t in range(j):
                        s = s - Lf[i][t] * Lf[j][t]
                    Lf[i][j] = torch.sqrt(s) if i == j else s / Lf[j][j]

            def square(T, sym):
                """(nc, k, k) from the lower triangle T (mirrored or zero)."""
                return torch.stack([
                    torch.stack([T[i][j] if j <= i else (T[j][i] if sym else zero)
                                 for j in range(k)], dim=-1)
                    for i in range(k)
                ], dim=-2)

            L = square(Lf, False)
            eye = torch.eye(k, dtype=dt, device=dev).expand_as(L)
            colours.append(dict(
                nc=idx.shape[1], idx=idx.T.reshape(-1),
                ridx=torch.where(idx < n, idx, 0).T.reshape(-1),
                mask=mask.T.unsqueeze(-1).contiguous(), A=square(A, True),
                Linv=torch.linalg.solve_triangular(L, eye, upper=False),
            ))
        centres = torch.cat([col["idx"].view(-1, k)[:, 0] for col in colours])
        stack = torch.stack([c.expand(shape) if c.ndim == 0 else c for c in op.coeffs], dim=-1)
        window = [torch.tensor([o[ax] + op.radius for o in op.offsets], device=dev) for ax in range(d)]
        self._plain.update(colours=colours, centres=centres, coeff_stack=stack, window_index=window)
        return self._plain

    def _residual(self, x, b):
        """b - A x over the grid, the neighbours gathered in one op from
        the (2 radius + 1)^d windows of the padded x."""
        op, d, r = self.base, self.base.ndim, self.base.radius
        tab = self._tables()
        w = F.pad(x, [r, r] * d)
        for _ in range(d):  # the next grid axis is always at -d
            w = w.unfold(-d, 2 * r + 1, 1)
        nb = w[(..., *tab["window_index"])]  # (*grid, noff)
        return b - op.diag * x - (tab["coeff_stack"] * nb).sum(-1)

    def step_with_noise(self, x, b, noises):
        """One full coloured patch sweep with explicit draws
        (deterministic).  ``b=None`` means a zero RHS; trailing chain dims
        of ``x`` (and the draws) are taken one chain at a time."""
        if x.ndim > self.base.ndim:
            return per_chain(self.step_with_noise, x, b, noises, self.base.ndim)
        if b is None:  # zero-RHS (prior) convention
            b = torch.zeros_like(x)
        tab = self._tables()
        shape, n, k = self.grid_shape, self.base.n, len(self.patch_offsets)
        # member j of the patch centred at p draws eta[j][p]: (centre, member)
        eta = noises[0]["eta"].reshape(k, n).T.index_select(0, tab["centres"])
        xe = torch.cat([x.reshape(-1), x.new_zeros(1)])  # x and the zero slot
        start = 0
        for col in tab["colours"]:
            nc, idx, mask = col["nc"], col["idx"], col["mask"]
            r = self._residual(xe[:n].view(shape), b).reshape(-1)
            xs = xe.index_select(0, idx).view(nc, k, 1)
            # rhs = mask (b - A x)_S + A_SS x_S; x_S = L^{-T} (L^{-1} rhs + eta)
            rhs = torch.baddbmm(mask * r.index_select(0, col["ridx"]).view(nc, k, 1), col["A"], xs)
            z = torch.baddbmm(eta[start:start + nc].unsqueeze(-1), col["Linv"], rhs)
            y = torch.bmm(col["Linv"].mT, z)
            xe = xe.index_copy(0, idx, torch.where(mask > 0.5, y, xs).view(-1))
            start += nc
        return xe[:n].view(shape)

    def step(self, key: int, x, b, aux=None):
        """(key, x'): one keyed sweep.  ``b=None`` declares a zero RHS
        (the kernels then read no b)."""
        batch = x.shape[self.base.ndim:]
        if self.has_kernel:
            refuse_batch(self, batch)
            key, k1, k2 = keys.split(key, 3)
            seed, stp = keys.randint31(k1), keys.randint31(k2)
            return key, fused_patch_sweep_sqfd(x, b, *self.sq_fd_params, seed, stp)
        key, sub = keys.split(key)
        return key, self.step_with_noise(x, b, _draw(sub, with_batch(self.noise_shapes(), batch), x.dtype, x.device))


@dataclass(frozen=True, eq=False)
class GraphPatchGibbsSampler:
    """Vertex-star block Gibbs on an unstructured GraphOperator (port of
    the JAX ``GraphPatchGibbsSampler``).

    The patch of node i is {i} and its neighbours, member lists padded to
    the largest patch ``kmax`` with the sentinel slot n.  A distance-4
    greedy colouring (the colouring of the cubed adjacency graph) makes
    same-colour patches uncoupled and member-disjoint, so one colour pass
    resamples all of its patches at once from their exact conditionals;
    a sweep is the colours in order.  Set-up (host) as in JAX.

    The JAX step unrolls each (kmax, kmax) Cholesky into elementwise ops
    to keep ``(..., k, k)`` arrays out of the TPU compiler.  Here each
    colour's patch matrices A_SS are gathered once, at create time, into a
    ``(m_c, kmax, kmax)`` stack and factored by ``torch.linalg.cholesky``;
    a pass is two batched triangular solves.  JAX's masked-slot convention
    holds: a padded member has a unit diagonal and no coupling, and its
    draw is thrown away.  The noise tree is JAX's, ``{"eta": (kmax, n)}``
    (member a of the patch centred at i takes ``eta[a, i]``), so
    explicit-noise steps agree with JAX to roundoff.  x may carry the
    chain axis, ``(n, C)``: the factors are shared by every chain."""

    base: object  # GraphOperator
    kmax: int
    # one (centres, members (m, k), mask (m, k), A_SS and its Cholesky
    # factor (m, k, k), the members' diagonal (m, k) and ELL rows (m, k, w),
    # the real members' rows and flat slots) per colour
    passes: tuple

    @staticmethod
    def create(op) -> "GraphPatchGibbsSampler":
        import numpy as np
        import scipy.sparse as sp

        from parmgmc_tpu_torch.operators.graph import greedy_coloring

        n = op.n
        vals = op.vals.detach().cpu().numpy()
        cols = op.cols.cpu().numpy()
        real = vals != 0.0
        deg = real.sum(axis=1)
        kmax = int(deg.max()) + 1
        members = np.full((n, kmax), n, dtype=np.int64)
        mask = np.zeros((n, kmax), dtype=bool)
        members[:, 0] = np.arange(n)
        mask[:, 0] = True
        for i in range(n):
            nb = cols[i][real[i]]
            members[i, 1 : 1 + len(nb)] = nb
            mask[i, 1 : 1 + len(nb)] = True

        # distance-4 colouring: same-colour centres more than 3 hops apart
        rows = np.repeat(np.arange(n), deg)
        B = sp.csr_matrix((np.ones(len(rows), bool), (rows, cols[real])), shape=(n, n)) + sp.eye(
            n, dtype=bool, format="csr")
        B3 = ((B @ B) @ B).tocsr()
        colors = greedy_coloring(B3.indptr, B3.indices, n)
        return GraphPatchGibbsSampler.from_sets(
            op, members, mask, [np.nonzero(colors == c)[0] for c in range(int(colors.max()) + 1)])

    @staticmethod
    def from_sets(op, members, mask, color_sets) -> "GraphPatchGibbsSampler":
        """The sampler of the host set-up: members (n, kmax) sentinel-padded
        with n, mask (n, kmax) of real members, and the centres of each
        colour in sweep order.  Factors each colour's A_SS stack on the
        operator's device."""
        import numpy as np

        n, kmax = members.shape
        dev = op.device
        vals_p = torch.cat([op.vals, op.vals.new_zeros((1, op.vals.shape[1]))])
        cols_p = torch.cat([op.cols, op.cols.new_full((1, op.cols.shape[1]), n)])
        diag_p = torch.cat([op.diag, op.diag.new_zeros(1)])
        passes = []
        for centres in color_sets:
            centres = np.asarray(centres, dtype=np.int64)
            mem_np = members[centres]
            msk_np = mask[centres]
            mem = torch.as_tensor(mem_np, device=dev)
            msk = torch.as_tensor(msk_np, device=dev)
            fm = msk.to(op.dtype)
            # A_SS by matching ELL columns (padding entries carry 0)
            va, ca = vals_p[mem], cols_p[mem]  # (m, k, w)
            off = (va[:, :, None, :] * (ca[:, :, None, :] == mem[:, None, :, None])).sum(-1)
            A = off * fm[:, :, None] * fm[:, None, :]
            eye = torch.eye(kmax, dtype=op.dtype, device=dev)
            dg = diag_p[mem] * fm + (1.0 - fm)
            A = A * (1.0 - eye) + torch.diag_embed(dg)
            L = torch.linalg.cholesky(A)
            sel = torch.as_tensor(np.flatnonzero(msk_np.reshape(-1)), device=dev)
            passes.append((torch.as_tensor(centres, device=dev), mem, fm, A, L, diag_p[mem], va, ca,
                           mem.reshape(-1)[sel], sel))
        return GraphPatchGibbsSampler(base=op, kmax=kmax, passes=tuple(passes))

    @property
    def ncolors(self) -> int:
        return len(self.passes)

    @property
    def grid_shape(self):
        return (self.base.n,)

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def noise_shapes(self):
        return [{"eta": (self.kmax, self.base.n)}]

    def prepare(self, b):
        return None

    def step_with_noise(self, x, b, noises):
        """One sweep with explicit N(0, 1) draws ``eta`` (kmax, n[, C])."""
        from parmgmc_tpu_torch.operators.graph import bcast

        n, k = self.base.n, self.kmax
        eta = noises[0]["eta"]
        batch = tuple(x.shape[1:])
        pad = x.new_zeros((1,) + batch)
        if b is None:
            b_p = x.new_zeros((n + 1,) + batch)
        else:
            b_p = torch.cat([bcast(b, x).expand((n,) + batch), pad])
        x_p = torch.cat([x, pad])  # slot n: the sentinel, always 0
        for centres, mem, fm, A, L, diag_s, vals_s, cols_s, rows, sel in self.passes:
            m = mem.shape[0]
            xm = x_p[mem]  # (m, k[, C])
            xs = xm if batch else xm[..., None]  # (m, k, C)
            # b_S - A_{S,rest} x_rest = mask (b - A x)_S + A_SS x_S, with
            # (A x) at the members' rows only
            g = x_p[cols_s]  # (m, k, w[, C])
            r = b_p[mem] - (bcast(diag_s, xm) * xm + (bcast(vals_s, g) * g).sum(dim=2))
            rhs = (r if batch else r[..., None]) * fm[..., None] + A @ xs
            z = torch.linalg.solve_triangular(L, rhs, upper=False)
            e = eta[:, centres].transpose(0, 1)  # (m, k[, C])
            y = torch.linalg.solve_triangular(L.transpose(-1, -2), z + (e if batch else e[..., None]), upper=True)
            y = y.reshape((m * k,) + batch)
            x_p = x_p.index_copy(0, rows, y[sel])
        return x_p[:n]

    def step(self, key: int, x, b, aux=None):
        key, sub = keys.split(key)
        shapes = with_batch(self.noise_shapes(), x.shape[1:])
        return key, self.step_with_noise(x, b, _draw(sub, shapes, x.dtype, x.device))
