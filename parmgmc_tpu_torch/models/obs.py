"""Observation operators for Bayesian linear inverse problems (port of
``parmgmc_tpu.models.obs``).

Observation i is the average of the field over a ball of radius r_i
around the centre c_i, with the grid's nodes in [0, 1]^d:

    column B[:, i] = M (1_{ball_i} / vol(ball_i))

with M the lumped mass h^d (halved once for each boundary axis).  The
membership and the weights are computed in float64 numpy on the host,
exactly as the JAX package computes them (the same arithmetic, axis by
axis, so the same bits), then moved to the requested dtype and device:

    B (*grid, nobs), sigma_inv = (1/sigma2) ones, f = B (sigma_inv y)

so that ``LRCOperator(base, B, sigma_inv)`` with the right-hand side f
targets the posterior.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from parmgmc_tpu_torch import resolve_device
from parmgmc_tpu_torch.operators.lrc import LRCOperator, with_patches

__all__ = [
    "grid_coordinates",
    "lumped_mass",
    "make_observation_mats",
    "make_posterior_operator",
]


def grid_coordinates(grid_shape) -> np.ndarray:
    """Node coordinates in [0, 1]^d, shape (*grid, d)."""
    axes = [np.linspace(0.0, 1.0, s) for s in grid_shape]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def lumped_mass(grid_shape) -> np.ndarray:
    """Diagonal (lumped) mass weights of the uniform grid, shape (*grid,)."""
    d = len(grid_shape)
    w = np.ones(grid_shape)
    for axis, s in enumerate(grid_shape):
        h = 1.0 / (s - 1)
        axis_w = np.full(s, h)
        axis_w[0] = axis_w[-1] = h / 2
        shape = [1] * d
        shape[axis] = s
        w = w * axis_w.reshape(shape)
    return w


def _ball_volume(d: int, r: float) -> float:
    if d == 2:
        return math.pi * r * r
    if d == 3:
        return 4.0 * math.pi / 3.0 * r**3
    raise ValueError("only d = 2, 3 are supported")


def _dist2(grid_shape, centre) -> np.ndarray:
    """Squared distance of every node to ``centre``: the coordinates'
    squared differences summed axis by axis in order, without the
    (*grid, d) coordinate array (0.4 GB at 256^3)."""
    d = len(grid_shape)
    out = None
    for ax, s in enumerate(grid_shape):
        shape = [1] * d
        shape[ax] = s
        term = ((np.linspace(0.0, 1.0, s) - centre[ax]) ** 2).reshape(shape)
        out = term if out is None else out + term
    return np.broadcast_to(out, tuple(grid_shape))


def make_observation_mats(grid_shape, sigma2: float, coords, radii, obsvals=None,
                          dtype=torch.float64, device=None):
    """(B, sigma_inv, f) for ball-average observations: ``coords`` the
    (nobs, d) ball centres, ``radii`` nobs radii, ``obsvals`` the observed
    values y (f is None without them)."""
    coords = np.asarray(coords, dtype=float)
    radii = np.asarray(radii, dtype=float)
    grid_shape = tuple(int(s) for s in grid_shape)
    nobs, d = coords.shape[0], len(grid_shape)
    device = resolve_device(device)
    mass = lumped_mass(grid_shape)
    B = torch.empty((*grid_shape, nobs), dtype=dtype, device=device)
    for i in range(nobs):
        ind = (_dist2(grid_shape, coords[i]) < radii[i] ** 2).astype(float) / _ball_volume(d, radii[i])
        B[..., i] = torch.from_numpy(mass * ind).to(device=device, dtype=dtype)
    sigma_inv = torch.full((nobs,), 1.0 / sigma2, dtype=dtype, device=device)
    f = None
    if obsvals is not None:
        y = torch.as_tensor(np.asarray(obsvals, dtype=float), dtype=dtype, device=device)
        f = B @ (sigma_inv * y)
    return B, sigma_inv, f


def make_posterior_operator(base, sigma2, coords, radii, obsvals=None):
    """(LRCOperator, f) for a Bayesian inverse problem on ``base``'s grid,
    dtype and device; ball columns are localized, so the operator carries
    the patch view (:func:`~parmgmc_tpu_torch.operators.lrc.with_patches`)."""
    B, sigma_inv, f = make_observation_mats(
        base.grid_shape, sigma2, coords, radii, obsvals, dtype=base.dtype, device=base.device
    )
    return with_patches(LRCOperator(base=base, B=B, sigma_inv=sigma_inv)), f
