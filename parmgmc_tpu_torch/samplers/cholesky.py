"""Exact Cholesky samplers (port of ``CholeskySampler``,
``SparseCholeskySampler`` and ``exact_sampler`` in
``parmgmc_tpu.samplers.cholesky``).

Draws exact samples of N(A^{-1} b, A^{-1}) as

    v = L^{-1} b,   y = L^{-T}(v + eta),   eta ~ N(0, I),   A = L L^T.

The explicit inverse ``Li = L^{-1}`` is cached at create time, so a
sample is two dense matvecs; it is kept only when ``Li L`` reproduces
the identity to near rounding, else the sampler falls back to triangular
solves (``Li = None``).  The MGMC coarsest level (512 DOF at 256^3) is
the main user; its matvecs stay ``torch.matmul``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from parmgmc_tpu_torch import keys

__all__ = ["CholeskySampler", "SparseCholeskySampler", "exact_sampler"]


@dataclass(frozen=True, eq=False)
class CholeskySampler:
    L: torch.Tensor  # (n, n) lower Cholesky factor
    Li: "torch.Tensor | None"  # (n, n) L^{-1}, or None (solves instead)
    grid_shape: tuple

    @staticmethod
    def create(op) -> "CholeskySampler":
        A = op.to_dense()
        L = torch.linalg.cholesky(A)
        n = L.shape[0]
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        Li = torch.linalg.solve_triangular(L, eye, upper=False)
        return CholeskySampler.from_factors(L, Li, op.grid_shape)

    @staticmethod
    def from_factors(L, Li, grid_shape) -> "CholeskySampler":
        """Sampler from a factor and its candidate inverse, dropping the
        inverse when it does not reproduce the identity to near rounding
        (it must not trade accuracy on ill-conditioned operators)."""
        if Li is not None:
            n = L.shape[0]
            eye = torch.eye(n, dtype=L.dtype, device=L.device)
            err = float(torch.abs(Li @ L - eye).max())
            if err > 1000 * torch.finfo(L.dtype).eps:
                Li = None
        return CholeskySampler(L=L, Li=Li, grid_shape=tuple(grid_shape))

    @property
    def n(self) -> int:
        return self.L.shape[0]

    @property
    def dtype(self):
        return self.L.dtype

    @property
    def device(self):
        return self.L.device

    def noise_shapes(self):
        return [{"eta": (self.n,)}]

    def _batch(self, v) -> tuple:
        return tuple(v.shape[len(self.grid_shape):])

    def prepare(self, b):
        """v = L^{-1} b (reusable across samples with a fixed b); b may
        carry trailing chain dims."""
        batch = self._batch(b)
        bf = b.reshape((self.n,) + batch)
        if self.Li is None:
            if batch:
                return torch.linalg.solve_triangular(self.L, bf, upper=False)
            return torch.linalg.solve_triangular(self.L, bf[:, None], upper=False)[:, 0]
        return self.Li @ bf

    def step_with_noise(self, x, b, noises, aux=None):
        del x  # exact sampler: iterates are i.i.d.
        v = aux if aux is not None else self.prepare(b)
        w = v + noises[0]["eta"]
        if self.Li is None:
            if w.ndim > 1:
                y = torch.linalg.solve_triangular(self.L.T, w, upper=True)
            else:
                y = torch.linalg.solve_triangular(self.L.T, w[:, None], upper=True)[:, 0]
        else:
            y = self.Li.T @ w
        return y.reshape(tuple(self.grid_shape) + tuple(w.shape[1:]))

    def step_words(self, key: int, words) -> int:
        """Append the keyed step's one generator seed under ``key`` to
        ``words`` (a :class:`~parmgmc_tpu_torch.keys.Words`); return the
        next key."""
        key, sub = keys.split(key)
        words.seed(sub)
        return key

    def step_from(self, cur, x, b, aux=None):
        """The keyed step on the words of :meth:`step_words`, read through
        the cursor ``cur``."""
        shape = (self.n,) + self._batch(x)
        eta = torch.randn(shape, generator=cur.generator(self.L.device), dtype=self.dtype,
                          device=self.L.device)
        return self.step_with_noise(x, b, [{"eta": eta}], aux)

    def step(self, key: int, x, b, aux=None):
        words = keys.Words()
        key = self.step_words(key, words)
        return key, self.step_from(words.cursor(), x, b, aux)


class SparseCholeskySampler:
    """Large-n exact sampler by a sparse LDL^T factor, on the HOST.

    The factorization and its triangular solves are sequential recurrences
    and run on the host, as in the JAX package: scipy SuperLU in symmetric
    mode (``diag_pivot_thresh=0``, ``SymmetricMode``) on an SPD matrix
    gives P A P^T = L D L^T with unit-lower L and D > 0, checked at create
    time (positive pivots, no pivoting, a probe residual).  Tensors come
    in from and go back to the caller's device; every draw crosses to the
    host and back, so this sampler is an exact reference and a standalone
    sampler, not a chain's inner step.

    Sampling map (exact, i.i.d.)::

        x = A^{-1} b + P^T L^{-T} D^{-1/2} eta,     eta ~ N(0, I)

    For an LRC operator A + B Sigma^{-1} B^T the base is factored and
    posterior draws use Matheron's rule:

        x0 = S eta,  eps ~ N(0, Sigma),  x = mu + x0 - C M^{-1}(B^T x0 + eps),
        C = A^{-1} B,  M = Sigma + B^T C,  mu = A^{-1} b - C M^{-1} B^T A^{-1} b.
    """

    def __init__(self, lu, d_sqrt, pc, grid_shape, dtype, device, lrc=None):
        self._lu = lu
        self._d_sqrt = d_sqrt  # sqrt(diag D)
        self._pc = pc  # column permutation (perm_c == perm_r)
        self.grid_shape = tuple(grid_shape)
        self.dtype = dtype
        self.device = device
        self._lrc = lrc  # None | dict(B, sigma, C, M_cho)
        self._Lt = None  # CSR of L^T for the triangular solves, made on use

    @staticmethod
    def create(op) -> "SparseCholeskySampler":
        import numpy as np
        from scipy.sparse.linalg import splu

        from parmgmc_tpu_torch.operators.lrc import LRCOperator

        lrc_op = op if isinstance(op, LRCOperator) else None
        base = op.base if lrc_op is not None else op
        if not hasattr(base, "to_csr"):
            raise TypeError(f"{type(base).__name__} has no to_csr(); sparse exact sampling needs a sparse assembly")
        A = base.to_csr().tocsc()
        n = A.shape[0]
        lu = splu(A, permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0.0, options=dict(SymmetricMode=True))
        d = lu.U.diagonal()
        if not (d > 0).all():
            raise ValueError("SuperLU symmetric-mode factorization gave a non-positive pivot: the operator is not SPD")
        if not np.array_equal(lu.perm_r, lu.perm_c):
            raise ValueError("SuperLU pivoted despite SymmetricMode: the LDL^T reading of the factors does not hold")
        rng = np.random.default_rng(0)
        v = rng.standard_normal(n)
        err = np.abs(A @ lu.solve(v) - v).max() / np.abs(v).max()
        if err > 1e-8:
            raise ValueError(f"sparse factor residual too large: {err}")
        lrc = None
        if lrc_op is not None:
            B = lrc_op.B.detach().cpu().double().numpy().reshape(n, -1)
            sigma = 1.0 / lrc_op.sigma_inv.detach().cpu().double().numpy()
            C = lu.solve(B)  # A^{-1} B, k sparse solves, once
            M = np.diag(sigma) + B.T @ C
            lrc = dict(B=B, sigma=sigma, C=C, M_cho=np.linalg.cholesky(M))
        return SparseCholeskySampler(lu, np.sqrt(d), lu.perm_c, base.grid_shape, base.dtype,
                                     base.device, lrc)

    @property
    def n(self) -> int:
        return self._d_sqrt.shape[0]

    def _mean_np(self, b):
        from scipy.linalg import cho_solve

        bf = torch.as_tensor(b).detach().cpu().double().numpy().reshape(self.n)
        mu = self._lu.solve(bf)
        if self._lrc is not None:
            lr = self._lrc
            mu = mu - lr["C"] @ cho_solve((lr["M_cho"], True), lr["B"].T @ mu)
        return mu

    def mean(self, b):
        """A^{-1} b (A_post^{-1} b on an LRC operator), grid-shaped, in
        float64 on the operator's device."""
        return torch.as_tensor(self._mean_np(b).reshape(self.grid_shape)).to(self.device)

    def _sqrt_apply(self, eta):
        """P^T L^{-T} D^{-1/2} eta for (n, m) eta (numpy): m samples
        through one triangular solve."""
        import scipy.sparse as sp
        from scipy.sparse.linalg import spsolve_triangular

        if self._Lt is None:
            self._Lt = sp.csr_matrix(self._lu.L.T)
        y = spsolve_triangular(self._Lt, eta / self._d_sqrt[:, None], lower=False)
        return y[self._pc]

    def sample(self, seed: int, n_samples: int, b=None):
        """(n_samples, *grid_shape) i.i.d. exact samples from numpy's
        ``default_rng(seed)``, on the operator's device."""
        import numpy as np
        from scipy.linalg import cho_solve

        rng = np.random.default_rng(seed)
        x0 = self._sqrt_apply(rng.standard_normal((self.n, n_samples)))
        if self._lrc is not None:
            lr = self._lrc
            eps = rng.standard_normal((len(lr["sigma"]), n_samples)) * np.sqrt(lr["sigma"])[:, None]
            x0 = x0 - lr["C"] @ cho_solve((lr["M_cho"], True), lr["B"].T @ x0 + eps)
        if b is not None:
            x0 = x0 + self._mean_np(b)[:, None]
        out = np.moveaxis(x0, -1, 0).reshape(n_samples, *self.grid_shape)
        return torch.as_tensor(out).to(device=self.device, dtype=self.dtype)

    def prepare(self, b):
        """The mean for a fixed chain right-hand side (one sparse solve
        pair, and the Woodbury solve on LRC), kept for the chain."""
        if b is None:
            return torch.zeros(self.grid_shape, dtype=self.dtype, device=self.device)
        return self.mean(b).to(self.dtype)

    def step(self, key: int, x, b, aux=None):
        """(key, x'): one i.i.d. draw through the host (eager only)."""
        del x
        key, sub = keys.split(key)
        mu = aux if aux is not None else self.prepare(b)
        return key, self.sample(keys.randint31(sub), 1)[0] + mu


def exact_sampler(op, dense_threshold: int = 20_000):
    """The dense CholeskySampler up to ``dense_threshold`` DOFs, the host's
    SparseCholeskySampler above it."""
    import math

    if math.prod(op.grid_shape) <= dense_threshold:
        return CholeskySampler.create(op)
    return SparseCholeskySampler.create(op)
