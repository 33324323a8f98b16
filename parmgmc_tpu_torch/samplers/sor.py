"""Multicolour SOR sweeps on stencil operators (port of ``color_masks``,
``num_colors`` and ``sor_sweep`` in ``parmgmc_tpu.samplers.sor``).

A parity colouring is a valid distance-1 colouring of any 3^d stencil:
star stencils take 2 colours by total-coordinate parity (red/black),
dense ones 2^d colours by per-coordinate parity.  Each colour update is
one masked stencil pass; colours run in sequence.
"""

from __future__ import annotations

import torch

from parmgmc_tpu_torch import resolve_device
from parmgmc_tpu_torch.operators.stencil import StencilOperator

__all__ = ["num_colors", "color_masks", "sor_sweep"]


def num_colors(op: StencilOperator) -> int:
    r = op.radius
    return (r + 1) if op.is_star() else (r + 1) ** op.ndim


def _iota(grid_shape, ax, device):
    view = [1] * len(grid_shape)
    view[ax] = grid_shape[ax]
    return torch.arange(grid_shape[ax], device=device).reshape(view)


def color_masks(grid_shape, ncolors: int, op: StencilOperator = None, device=None):
    """Boolean masks, one per colour, tiling the grid (on the card unless
    ``device`` says otherwise)."""
    grid_shape = tuple(grid_shape)
    device = resolve_device(device)
    d = len(grid_shape)
    r = op.radius if op is not None else 1
    base = r + 1
    if ncolors == base:  # star colouring
        code = sum(_iota(grid_shape, ax, device) for ax in range(d)) % base
    elif ncolors == base**d:
        code = torch.zeros(grid_shape, dtype=torch.int64, device=device)
        for ax in range(d):
            code = base * code + _iota(grid_shape, ax, device) % base
    else:
        raise ValueError(f"unsupported ncolors={ncolors} for d={d}, r={r}")
    code = code.expand(grid_shape)
    return tuple(code == c for c in range(ncolors))


def sor_sweep(op: StencilOperator, b, x, omega: float = 1.0, sweep: str = "forward", masks=None):
    """One multicolour SOR sweep; ``sweep`` in {forward, backward, symmetric}:
    ``x_r <- (1-omega) x_r + (omega/d_r) (b_r - sum_{j != r} a_rj x_j)``
    colour by colour (backward = reverse colour order)."""
    if masks is None:
        masks = color_masks(op.grid_shape, num_colors(op), op, device=x.device)
    if sweep == "symmetric":
        x = sor_sweep(op, b, x, omega, "forward", masks)
        return sor_sweep(op, b, x, omega, "backward", masks)
    order = range(len(masks)) if sweep == "forward" else reversed(range(len(masks)))
    inv_diag = omega / op.diag
    for c in order:
        r = b - op.offdiag_apply(x)
        xc = (1.0 - omega) * x + inv_diag * r
        x = torch.where(masks[c], xc, x)
    return x
