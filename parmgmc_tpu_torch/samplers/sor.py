"""Multicolour and natural-order SOR sweeps on stencil operators (port of
``parmgmc_tpu.samplers.sor``: ``color_masks``, ``num_colors``,
``sor_sweep``, ``natural_sweep``, ``NaturalGibbsSampler`` and
``lexicographic_sweep``).

A parity colouring is a valid distance-1 colouring of any 3^d stencil:
star stencils take 2 colours by total-coordinate parity (red/black),
dense ones 2^d colours by per-coordinate parity.  Colours run in
sequence.  A star colour is one masked stencil pass over the grid; a
dense colour is a product sublattice, so its update reads and writes
that sublattice alone through strided views (the same arithmetic at
each point, 2^d times less work).

The natural (lexicographic) order is scheduled by wavefronts
(:func:`natural_sweep`): the reference's PCPARSOR sampler configuration,
checked against the sequential scan :func:`lexicographic_sweep`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from parmgmc_tpu_torch import keys, resolve_device
from parmgmc_tpu_torch.operators.stencil import StencilOperator, lattice

__all__ = [
    "num_colors",
    "color_masks",
    "sor_sweep",
    "sublattice_update",
    "natural_sweep",
    "NaturalGibbsSampler",
    "lexicographic_sweep",
]


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


def sublattice_update(xp, b, inv_diag, offsets, coeffs, shape, r: int, omega: float, c: int,
                      origin=None) -> None:
    """Colour ``c`` of the dense colouring, in place in ``xp``: the
    sublattice i_ax = p_ax mod (r + 1) (p the base-(r + 1) digits of c,
    axis 0 the most significant, as :func:`color_masks` codes it) of the
    block of extents ``shape`` padded by r cells on every side in ``xp``
    (zeros, or the neighbouring blocks' values).  ``origin`` is the
    global index of the block's first point (the digits follow the global
    index); ``b``, ``inv_diag`` and the coefficient fields are
    block-shaped.  Each point sums its neighbours in the order of
    ``offsets``, as ``offdiag_apply`` does."""
    d = len(shape)
    base = r + 1
    origin = (0,) * d if origin is None else origin
    digits = [(c // base ** (d - 1 - ax)) % base for ax in range(d)]
    first = [(p - o) % base for p, o in zip(digits, origin)]
    counts = [len(range(f, n, base)) for f, n in zip(first, shape)]
    if 0 in counts:
        return
    y = None
    for off, coef in zip(offsets, coeffs):
        nbr = lattice(xp, [r + f + o for f, o in zip(first, off)], counts, base)
        t = (coef if coef.ndim == 0 else lattice(coef, first, counts, base)) * nbr
        y = t if y is None else y + t
    rr = lattice(b, first, counts, base) - y
    here = lattice(xp, [r + f for f in first], counts, base)
    here.copy_((1.0 - omega) * here + lattice(inv_diag, first, counts, base) * rr)


def _sublattice_sweep(op: StencilOperator, b, x, omega: float, order):
    """The dense colouring's sweep, colour by colour in place in a
    zero-padded copy of x (:func:`sublattice_update`)."""
    shape, d, r = op.grid_shape, op.ndim, op.radius
    xp = F.pad(x, [r, r] * d)
    inv_diag = omega / op.diag
    for c in order:
        sublattice_update(xp, b, inv_diag, op.offsets, op.coeffs, shape, r, omega, c)
    return xp[(Ellipsis, *(slice(r, r + n) for n in shape))].contiguous()


def sor_sweep(op: StencilOperator, b, x, omega: float = 1.0, sweep: str = "forward", masks=None):
    """One multicolour SOR sweep; ``sweep`` in {forward, backward, symmetric}:
    ``x_r <- (1-omega) x_r + (omega/d_r) (b_r - sum_{j != r} a_rj x_j)``
    colour by colour (backward = reverse colour order).  Dense colourings
    update each colour's sublattice alone unless ``masks`` are given."""
    if sweep == "symmetric":
        x = sor_sweep(op, b, x, omega, "forward", masks)
        return sor_sweep(op, b, x, omega, "backward", masks)
    ncolors = num_colors(op)
    order = range(ncolors) if sweep == "forward" else reversed(range(ncolors))
    if masks is None and not op.is_star():
        return _sublattice_sweep(op, b, x, omega, order)
    if masks is None:
        masks = color_masks(op.grid_shape, ncolors, op, device=x.device)
    inv_diag = omega / op.diag
    for c in order:
        r = b - op.offdiag_apply(x)
        xc = (1.0 - omega) * x + inv_diag * r
        x = torch.where(masks[c], xc, x)
    return x


def natural_sweep(op: StencilOperator, b, x, omega: float = 1.0, sweep: str = "forward"):
    """The exact natural-order (lexicographic) SOR sweep by wavefronts.

    For a star stencil every lexicographically earlier neighbour of a
    cell has a strictly smaller coordinate sum and no two cells of equal
    sum couple, so updating the hyperplanes sum(coords) == s in
    increasing s is lexicographic Gauss-Seidel exactly.  Non-star
    stencils take skewed weights w_{d-1} = 1, w_ax = r sum(later w) + 1,
    which give every lexicographically negative offset w . o < 0 and no
    offset w . o == 0.  Each wavefront is one masked pass over the grid
    (S passes, the code grid built once)."""
    if sweep == "symmetric":
        x = natural_sweep(op, b, x, omega, "forward")
        return natural_sweep(op, b, x, omega, "backward")
    d, shape = op.ndim, op.grid_shape
    w = [1] * d
    if not op.is_star():
        for ax in reversed(range(d - 1)):
            w[ax] = op.radius * sum(w[ax + 1:]) + 1
    n_fronts = sum(wi * (n - 1) for wi, n in zip(w, shape)) + 1
    code = sum(w[ax] * _iota(shape, ax, x.device) for ax in range(d))
    inv_diag = omega / op.diag
    fronts = range(n_fronts) if sweep == "forward" else reversed(range(n_fronts))
    for s in fronts:
        r = b - op.offdiag_apply(x)
        xc = (1.0 - omega) * x + inv_diag * r
        x = torch.where(code == s, xc, x)
    return x


@dataclass(frozen=True, eq=False)
class NaturalGibbsSampler:
    """Stochastic SOR Gibbs sampler in exact natural order (the PCPARSOR
    configuration, scheduled by :func:`natural_sweep`): the target and
    the stochastic right-hand side b~ = b + sqrt((2 - omega)/omega)
    sqrt(D) eta of ``GibbsSampler``, another update order.  Registry
    type ``{"type": "gibbs", "ordering": "natural"}``.  No kernel: the
    keyed step draws explicit noise."""

    base: StencilOperator
    noise_scale: torch.Tensor
    omega: float = 1.0
    sweep: str = "forward"

    @staticmethod
    def create(op, omega: float = 1.0, sweep: str = "forward") -> "NaturalGibbsSampler":
        if not isinstance(op, StencilOperator):
            raise TypeError("NaturalGibbsSampler needs a StencilOperator")
        if sweep not in ("forward", "backward", "symmetric"):
            raise ValueError(f"unknown sweep {sweep!r}")
        scale = math.sqrt((2.0 - omega) / omega) * torch.sqrt(op.diag)
        return NaturalGibbsSampler(base=op, noise_scale=scale, omega=omega, sweep=sweep)

    @property
    def grid_shape(self):
        return self.base.grid_shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def noise_shapes(self):
        halves = 2 if self.sweep == "symmetric" else 1
        return [{"eta": self.grid_shape} for _ in range(halves)]

    def step_with_noise(self, x, b, noises):
        """One iteration with explicit N(0,1) draws; ``b=None`` is a zero
        RHS.  A symmetric sweep draws fresh noise for each half."""
        if b is None:
            b = torch.zeros_like(x)
        if self.sweep == "symmetric":
            x = natural_sweep(self.base, b + self.noise_scale * noises[0]["eta"], x, self.omega, "forward")
            return natural_sweep(self.base, b + self.noise_scale * noises[1]["eta"], x, self.omega,
                                 "backward")
        btilde = b + self.noise_scale * noises[0]["eta"]
        return natural_sweep(self.base, btilde, x, self.omega, self.sweep)

    def prepare(self, b):
        return None

    def step(self, key: int, x, b, aux=None):
        from parmgmc_tpu_torch.samplers.gibbs import _draw

        key, sub = keys.split(key)
        return key, self.step_with_noise(x, b, _draw(sub, self.noise_shapes(), x.dtype, x.device))


def lexicographic_sweep(op: StencilOperator, b, x, omega: float = 1.0, sweep: str = "forward"):
    """Sequential natural-order SOR sweep over the dense matrix, one row at
    a time: the test oracle of :func:`natural_sweep` (small grids only)."""
    if sweep == "symmetric":
        x = lexicographic_sweep(op, b, x, omega, "forward")
        return lexicographic_sweep(op, b, x, omega, "backward")
    A = op.to_dense()
    n = A.shape[0]
    dg = torch.diagonal(A)
    xf = x.reshape(n).clone()
    bf = b.reshape(n)
    for i in (range(n) if sweep == "forward" else reversed(range(n))):
        s = A[i] @ xf - dg[i] * xf[i]
        xf[i] = (1.0 - omega) * xf[i] + (omega / dg[i]) * (bf[i] - s)
    return xf.reshape(x.shape)
