"""Canonical test problems (port of ``parmgmc_tpu.models.problems``)."""

from __future__ import annotations

import itertools

import torch

from parmgmc_tpu_torch.operators.stencil import (
    StencilOperator,
    compress_stencil,
    link_count,
    shifted_laplace_fd,
    star_offsets,
)

__all__ = ["gmrf_2d", "gmrf_3d", "squared_shifted_laplace_fd"]


def gmrf_2d(n: int, kappa: float = 1.0, dtype=torch.float32, device=None) -> StencilOperator:
    """2D shifted-Laplace GMRF precision on an n x n grid."""
    return shifted_laplace_fd((n, n), kappa, dtype=dtype, device=device)


def gmrf_3d(n: int, kappa: float = 1.0, dtype=torch.float32, device=None) -> StencilOperator:
    """3D 7-point shifted-Laplace GMRF precision on an n^3 grid."""
    return shifted_laplace_fd((n, n, n), kappa, dtype=dtype, device=device)


def squared_shifted_laplace_fd(
    grid_shape, kappa: float, dtype=torch.float32, device=None
) -> StencilOperator:
    """(kappa^2 - Laplace)^2 prior precision as a radius-2 stencil.

    The square of F = kappa^2 + hinv2 * links (``fd_stencil``, hinv2 =
    (n0 - 1)^2), composed in closed form; writing ``g_u(j) = [j + u in
    grid]`` for the unit offsets u and d = kappa^2 + hinv2 * L(j):

      diag        d(j)^2 + hinv2^2 L(j)
      coeff[u]    -hinv2 (d(j) + d(j+u) g_u(j))
      coeff[2u]   hinv2^2 g_u(j)
      coeff[u+v]  hinv2^2 (g_u(j) + g_v(j)),  u, v on different axes

    :func:`compress_stencil` then keeps the diagonal and the 2d unit
    offsets as fields and turns the 2u and u+v offsets into scalars.
    """
    shape = tuple(int(s) for s in grid_shape)
    A = shifted_laplace_fd(shape, kappa, dtype=dtype, device=device)
    dev, d = A.device, A.ndim
    h = float((shape[0] - 1) ** 2)
    k2 = float(kappa) ** 2

    def g(u):
        # [j + u in grid] for a single-axis unit offset u
        ax = next(a for a, o in enumerate(u) if o)
        i = torch.arange(shape[ax], device=dev)
        m = ((i < shape[ax] - 1) if u[ax] > 0 else (i > 0)).to(dtype)
        view = [1] * d
        view[ax] = shape[ax]
        return m.reshape(view).expand(shape)

    units = star_offsets(d)
    gs = {u: g(u) for u in units}
    L = link_count(shape, dtype, dev)
    dg = k2 + h * L
    diag = dg**2 + h * h * L

    def shift_diag(u):
        # d(j + u), zero where j + u leaves the grid
        ax = next(a for a, o in enumerate(u) if o)
        n, o = shape[ax], u[ax]
        moved = dg.narrow(ax, max(0, o), n - 1)
        zeros = torch.zeros_like(dg.narrow(ax, 0, 1))
        return torch.cat([moved, zeros] if o > 0 else [zeros, moved], dim=ax)

    coeffs = {}
    for u in units:
        coeffs[u] = -h * (dg + shift_diag(u))
        coeffs[tuple(2 * o for o in u)] = h * h * gs[u]
    for u, v in itertools.combinations(units, 2):
        if any(a and b for a, b in zip(u, v)):
            continue  # same axis (u = -v): those paths land on the diagonal
        coeffs[tuple(a + b for a, b in zip(u, v))] = h * h * (gs[u] + gs[v])
    return compress_stencil(
        StencilOperator(offsets=tuple(coeffs), coeffs=tuple(coeffs.values()), diag=diag)
    )
