"""Red/black Gibbs sweeps on axis-0 blocks with a hand-made halo
exchange (port of ``parmgmc_tpu.parallel.sharded``; plain torch, as the
JAX module is plain lax).

A field is a list of per-slot blocks along grid axis 0 (see
:mod:`.mesh`).  Two sweep formulations:

* ``halo_mode="exact"`` -- the halos are exchanged before every colour,
  so the sweep is the single-device multicolour Gauss-Seidel operator:
  the reference's per-colour ghost gathers (``mc_sor.c:316-341``);
* ``halo_mode="frozen"`` -- the halos are exchanged once a sweep and
  held; each block sweeps against stale neighbour values (block
  Gauss-Seidel within a block, Jacobi across blocks).  The reference's
  intentionally inexact local-forward ("Hogwild") mode
  (``-pc_sorgibbs_local_forward``, ``pc_sorgibbs.c:264-278``): exact on
  one block, approximate across blocks.

Radius-1 star stencils with scalar off-diagonal coefficients (the FD
family), 2D or 3D, sharded along the first grid axis.
"""

from __future__ import annotations

import torch

from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.kernels._twin import noise_factor, shift
from parmgmc_tpu_torch.parallel.mesh import Mesh, canonical, exchange_planes, shard_array

__all__ = ["sharded_gibbs_sweep", "make_sharded_gibbs_step"]


def _local_color_update(x_loc, lo, hi, b_loc, d_loc, coeffs, omega, mask):
    """Masked SOR update of one colour on a block with the halo planes
    ``lo`` and ``hi``."""
    n0 = x_loc.shape[0]
    xp = torch.cat([lo, x_loc, hi], dim=0)
    sumn = coeffs[0] * xp[0:n0] + coeffs[1] * xp[2 : 2 + n0]
    for ax in range(1, x_loc.ndim):
        sumn = sumn + coeffs[2 * ax] * shift(x_loc, ax, -1)
        sumn = sumn + coeffs[2 * ax + 1] * shift(x_loc, ax, 1)
    upd = (1.0 - omega) * x_loc + (omega / d_loc) * (b_loc - sumn)
    return torch.where(mask, upd, x_loc)


def _parity(x_loc, row0: int) -> torch.Tensor:
    """(global row + the other indices) % 2 over a block whose first row
    is global row ``row0``."""
    idx = torch.zeros(x_loc.shape, dtype=torch.int64, device=x_loc.device)
    for ax, n in enumerate(x_loc.shape):
        view = [1] * x_loc.ndim
        view[ax] = n
        i = torch.arange(n, device=x_loc.device).reshape(view)
        idx = idx + (i + row0 if ax == 0 else i)
    return idx % 2


def sharded_gibbs_sweep(xs, bs, ds, coeffs, omega, sweep: str = "forward",
                        halo_mode: str = "exact") -> list:
    """One SOR sweep of the blocks ``xs`` on the right-hand sides ``bs``
    and diagonals ``ds`` (lists of blocks of equal extent along axis 0);
    ``coeffs`` holds, a slot, the 2d off-diagonal scalars ordered (-e0,
    +e0, -e1, +e1, ...) (see the module note for ``halo_mode``)."""
    if sweep not in ("forward", "backward"):
        raise ValueError(f"a sharded sweep runs forward or backward, got {sweep!r}")
    if halo_mode not in ("exact", "frozen"):
        raise ValueError(f"unknown halo_mode {halo_mode!r} (exact or frozen)")
    n0 = xs[0].shape[0]
    masks = [_parity(x, i * n0) for i, x in enumerate(xs)]
    colors = (0, 1) if sweep == "forward" else (1, 0)
    halos = exchange_planes(xs, 1) if halo_mode == "frozen" else None
    for c in colors:
        if halo_mode == "exact":
            halos = exchange_planes(xs, 1)
        xs = [_local_color_update(x, lo, hi, b, d, q, omega, m == c)
              for x, (lo, hi), b, d, q, m in zip(xs, halos, bs, ds, coeffs, masks)]
    return xs


def make_sharded_gibbs_step(op, mesh: Mesh, omega: float = 1.0, sweep: str = "forward",
                            halo_mode: str = "exact", axis_name: str = "x"):
    """step(key, xs, bs) -> (key, xs'): a Gibbs chain step on blocks of
    grid axis 0 over the slots of ``axis_name`` (``bs`` None: a zero
    right-hand side).

    The noise of each half-sweep, eta ~ N(0, I) on the whole grid, is
    drawn once on the first slot's device from the step's key and split
    into blocks (outside the shards, as the JAX step draws it), so both
    halo modes target the documented distributions."""
    if not (op.is_star() and op.radius == 1 and all(c.ndim == 0 for c in op.coeffs)):
        raise ValueError("a sharded Gibbs step needs a radius-1 star stencil with scalar "
                         "off-diagonals")
    if sweep not in ("forward", "backward", "symmetric"):
        raise ValueError(f"unknown sweep {sweep!r}")
    d = op.ndim
    cmap = dict(zip(op.offsets, op.coeffs))
    order = []
    for ax in range(d):
        for s in (-1, 1):
            off = [0] * d
            off[ax] = s
            order.append(tuple(off))
    coeffs = torch.stack([cmap[o] for o in order]).to(op.dtype)
    slots = [canonical(s) for s in mesh.slots(axis_name)]
    qs = [coeffs.to(dev) for dev in slots]
    diag = op.diag
    ds = shard_array(diag, mesh, axis_name=axis_name)
    nscale = shard_array(noise_factor(omega, op.dtype) * torch.sqrt(diag), mesh,
                         axis_name=axis_name)
    halves = ("forward", "backward") if sweep == "symmetric" else (sweep,)
    shape, dtype = tuple(op.grid_shape), op.dtype

    def step(key: int, xs, bs):
        for h in halves:  # fresh noise a half-sweep
            key, sub = keys.split(key)
            eta = torch.randn(shape, generator=keys.generator(sub, slots[0]), dtype=dtype,
                              device=slots[0])
            es = shard_array(eta, mesh, axis_name=axis_name)
            bts = [s * e if b is None else b + s * e
                   for b, s, e in zip(bs or [None] * len(xs), nscale, es)]
            xs = sharded_gibbs_sweep(xs, bts, ds, qs, omega, sweep=h, halo_mode=halo_mode)
        return key, xs

    return step
