"""Woodbury composite sampler: posterior samples from a prior sampler (port
of ``parmgmc_tpu.samplers.woodbury``).

Given an LRC posterior precision A + B Sigma^{-1} B^T, any sampler of the
prior N(A^{-1} ., A^{-1}) becomes a posterior sampler.  One iteration:

    w  = b + B sqrt(Sigma^{-1}) eta_lr
    y  <- one prior-sampler step with right-hand side w
    y  <- y - G (B^T y),     G = A^{-1} B (Sigma + B^T A^{-1} B)^{-1}

G is built at create time with an exact solve for A: dense for small
grids, conjugate gradients column by column otherwise.  The correction
leaves the posterior invariant exactly when the inner sampler draws exact
prior samples (:class:`~parmgmc_tpu_torch.samplers.cholesky.CholeskySampler`);
with Gibbs or MGMC inside it is biased, and those samplers run on the
``LRCOperator`` directly instead.  The step runs no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.samplers.gibbs import _draw
from parmgmc_tpu_torch.solvers import cg

__all__ = ["WoodburySampler"]


def _solve_columns_dense(base, B):
    """A^{-1} B by a dense solve (small grids; exact)."""
    A = base.to_dense()
    return torch.linalg.solve(A, B.reshape(base.n, -1)).reshape(B.shape)


def _solve_columns_cg(base, B, tol=None, maxiter=10_000):
    """A^{-1} B matrix-free, one CG solve a column (large grids).  The
    default tolerance follows the dtype: 1e-10 cannot be reached in
    float32."""
    if tol is None:
        tol = 1e-10 if B.dtype == torch.float64 else 2e-6
    # unpreconditioned CG from zero, JAX's stopping rule; reads |r|^2 to
    # the host every step (set-up only)
    cols = [cg(base.apply, B[..., j].contiguous(), tol=tol, maxiter=maxiter)[0] for j in range(B.shape[-1])]
    return torch.stack(cols, dim=-1)


@dataclass(frozen=True, eq=False)
class WoodburySampler:
    sampler: object  # prior sampler targeting N(A^{-1} ., A^{-1})
    B: torch.Tensor  # (*grid, k)
    sqrt_sigma_inv: torch.Tensor  # (k,)
    G: torch.Tensor  # (*grid, k)

    @staticmethod
    def create(op, sampler, solver: str = "auto") -> "WoodburySampler":
        base, B, sigma_inv = op.base, op.B, op.sigma_inv
        if solver == "dense" or (solver == "auto" and base.n <= 16384):
            C = _solve_columns_dense(base, B)
        else:
            C = _solve_columns_cg(base, B)
        grid = list(range(base.ndim))
        small = torch.diag(1.0 / sigma_inv) + torch.tensordot(B, C, dims=(grid, grid))
        Sb = torch.linalg.solve(small, torch.eye(op.k, dtype=B.dtype, device=B.device))
        return WoodburySampler(sampler=sampler, B=B, sqrt_sigma_inv=torch.sqrt(sigma_inv), G=C @ Sb)

    @property
    def grid_shape(self):
        return self.sampler.grid_shape

    @property
    def base(self):
        return self.sampler.base

    @property
    def dtype(self):
        return self.B.dtype

    @property
    def device(self):
        return self.B.device

    def noise_shapes(self):
        return {"eta_lr": (self.B.shape[-1],), "inner": self.sampler.noise_shapes()}

    def step_with_noise(self, x, b, noises):
        """One iteration with explicit N(0,1) draws; ``b=None`` is a zero RHS."""
        w = self.B @ (self.sqrt_sigma_inv * noises["eta_lr"])
        if b is not None:
            w = b + w
        y = self.sampler.step_with_noise(x, w, noises["inner"])
        return y - self.G @ torch.tensordot(y, self.B, dims=y.ndim)

    def prepare(self, b):
        return None

    def step(self, key: int, x, b, aux=None):
        key, sub = keys.split(key)
        return key, self.step_with_noise(x, b, _draw(sub, self.noise_shapes(), x.dtype, x.device))
