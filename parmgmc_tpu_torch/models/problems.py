"""Canonical test problems (port of ``parmgmc_tpu.models.problems``)."""

from __future__ import annotations

import torch

from parmgmc_tpu_torch.operators.stencil import StencilOperator, shifted_laplace_fd

__all__ = ["gmrf_2d", "gmrf_3d"]


def gmrf_2d(n: int, kappa: float = 1.0, dtype=torch.float32, device=None) -> StencilOperator:
    """2D shifted-Laplace GMRF precision on an n x n grid."""
    return shifted_laplace_fd((n, n), kappa, dtype=dtype, device=device)


def gmrf_3d(n: int, kappa: float = 1.0, dtype=torch.float32, device=None) -> StencilOperator:
    """3D 7-point shifted-Laplace GMRF precision on an n^3 grid."""
    return shifted_laplace_fd((n, n, n), kappa, dtype=dtype, device=device)
