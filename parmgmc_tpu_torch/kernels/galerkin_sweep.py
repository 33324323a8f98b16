"""The colour sweep of a 3D 27-point stencil: CUDA kernel wrapper and twin.

The linear-Galerkin hierarchy (``MGMCSampler``'s default) makes every 3D
level below the finest a radius-1 stencil of up to 26 offsets whose
coefficients are scalars or grid fields (``compress_stencil``), coloured
by the 2^3 parities.  One call of :func:`fused_galerkin_sweep` is one
stochastic SOR (Gibbs) sweep of such an operator, out of place:

    b~ = b + sqrt((2 - omega)/omega) sqrt(D) eta          (b = None: 0)
    for colour c = 4 (i % 2) + 2 (j % 2) + k % 2 in order (backward: reversed):
        x_r <- (1 - omega) x_r + (omega / D_r) (b~_r - sum_m a_m,r x_{r + o_m})

with eta the counter-hash draw of :mod:`._noise` keyed by (seed, step,
:data:`~._noise.GALERKIN_DOMAIN`, flat index).  The twin
(:func:`fused_galerkin_sweep_reference`) is the plain sublattice sweep of
:mod:`parmgmc_tpu_torch.samplers.sor` on b~; the kernel
(``csrc/galerkin_sweep.cu``) rounds every operation as the twin's torch
ops do, so the two agree bit for bit.  No TPU kernel computes this: the
JAX package leaves the sweep of its Galerkin levels to XLA.

The kernel reads the coefficient fields and D colour-major (:func:`pack`,
made once a sampler), so a colour's threads read them coalesced.  A call
is :data:`LAUNCHES` launches, one a colour in sweep order (one cooperative
launch with a grid barrier between colours was slower at 128^3 on the
H100; ``csrc/galerkin_sweep.cu`` has the numbers).  Each launch is a
loop of constant length over 26 offsets that issues every load of a
point before its first product, its scalar coefficients read from the
pack's array in device memory (``scalars_at``); a stencil of fewer
offsets reads 0.0 there for the rest, each such term adding +-0 to the
sum.  Each CUDA call takes the hash prefix by value or, with
``prefix_at`` (an int32 CUDA tensor of one word), from device memory when
it runs (a step replayed from a CUDA graph, :mod:`parmgmc_tpu_torch.replay`);
the draws are the same either way.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.kernels import _noise, _twin
from parmgmc_tpu_torch.operators.stencil import StencilOperator, lattice

__all__ = ["Pack", "pack", "supported", "fused_galerkin_sweep", "fused_galerkin_sweep_reference"]

COLOURS = 8
LAUNCHES = COLOURS  # a call's launches: one a colour


def supported(op) -> bool:
    """Does the kernel take ``op``?  A 3D radius-1 stencil that is not a
    star (a star takes the red/black kernels of ``kernels.rb_gibbs``)."""
    return (isinstance(op, StencilOperator) and op.ndim == 3 and not op.is_star()
            and op.radius == 1 and 1 <= len(op.offsets) <= kernels.MAX_OFF)


def _order(sweep: str):
    if sweep not in ("forward", "backward"):
        raise ValueError(f"a sweep kernel runs one forward/backward sweep, got {sweep!r}")
    return range(COLOURS) if sweep == "forward" else reversed(range(COLOURS))


def _parities(c: int) -> tuple:
    return (c >> 2) & 1, (c >> 1) & 1, c & 1


def _colour_major(field) -> torch.Tensor:
    """``field`` with each colour's sublattice in a block of its own,
    colours in order, each row-major: the kernel's layout."""
    parts = []
    for c in range(COLOURS):
        first = _parities(c)
        counts = [len(range(f, n, 2)) for f, n in zip(first, field.shape)]
        parts.append(lattice(field, first, counts, 2).reshape(-1))
    return torch.cat(parts)


@dataclass(frozen=True, eq=False)
class Pack:
    """What the kernel reads of an operator: its grid-shaped coefficients
    stacked colour-major (``fields``, (f, n)), D colour-major, each offset,
    the field of each offset (-1: a scalar) and the scalars in device
    memory (``scalars_at``, ``kernels.MAX_OFF`` float32 values, 0.0 where a
    field and past the offsets)."""

    fields: torch.Tensor
    diag: torch.Tensor
    offsets: tuple
    slots: tuple
    scalars_at: torch.Tensor


def pack(op: StencilOperator) -> Pack:
    """The kernel's view of ``op`` (set-up: each field is copied once)."""
    if not supported(op):
        raise ValueError("the Galerkin sweep kernel takes a 3D radius-1 stencil that is not a star")
    fields, slots, scalars = [], [], []
    for c in op.coeffs:
        if c.ndim == 0:
            slots.append(-1)
            scalars.append(float(c.to(torch.float32)))
        else:
            slots.append(len(fields))
            scalars.append(0.0)
            fields.append(_colour_major(c))
    stack = torch.stack(fields) if fields else op.diag.new_zeros((1, op.n))
    return Pack(fields=stack.contiguous(), diag=_colour_major(op.diag).contiguous(),
                offsets=tuple(tuple(int(v) for v in o) for o in op.offsets), slots=tuple(slots),
                scalars_at=kernels.scalar_array(scalars, op.device))


def fused_galerkin_sweep_reference(x, b, op, omega, seed, step, *, sweep="forward",
                                   with_noise=True):
    """Plain-torch twin of :func:`fused_galerkin_sweep` (any device): the
    sublattice sweep of ``samplers.sor`` on b + sqrt((2 - omega)/omega)
    sqrt(D) eta."""
    from parmgmc_tpu_torch.samplers.sor import _sublattice_sweep

    order = _order(sweep)
    bt = torch.zeros_like(x) if b is None else b
    if with_noise:
        prefix = _noise.hash_prefix(seed, step, _noise.GALERKIN_DOMAIN)
        eta = _noise.eta_hash(prefix, _twin.flat_index(tuple(x.shape), x.device), x.dtype)
        bt = bt + (_twin.noise_factor(omega, x.dtype) * torch.sqrt(op.diag)) * eta
    return _sublattice_sweep(op, bt, x, omega, order)


def fused_galerkin_sweep(x, b, op, omega, seed, step, *, sweep="forward", with_noise=True,
                         prefix_at=None, packed=None):
    """x': one stochastic sweep of the 27-point stencil ``op`` from x.

    CPU tensors run :func:`fused_galerkin_sweep_reference`; CUDA tensors
    launch ``csrc/galerkin_sweep.cu`` (float32, contiguous) or raise.
    ``packed`` is :func:`pack` of ``op`` (made here when not given: a
    sampler keeps its own)."""
    if x.device.type == "cpu":
        return fused_galerkin_sweep_reference(x, b, op, omega, seed, step, sweep=sweep,
                                              with_noise=with_noise)
    backward = int(sweep == "backward")
    _order(sweep)
    if x.ndim != 3 or tuple(x.shape) != tuple(op.grid_shape):
        raise ValueError(f"x shape {tuple(x.shape)} != the operator's grid {tuple(op.grid_shape)}")
    if x.numel() >= 2**30:
        raise ValueError("the Galerkin sweep kernel takes grids of fewer than 2^30 points")
    p = pack(op) if packed is None else packed
    for name, t in (("x", x), ("b", b), ("fields", p.fields), ("diag", p.diag),
                    ("scalars_at", p.scalars_at)):
        if t is not None:
            kernels.check_input(name, t, x)
    if b is not None and b.shape != x.shape:
        raise ValueError(f"b shape {tuple(b.shape)} != x shape {tuple(x.shape)}")
    at = kernels.prefix_pointer(prefix_at, 1, x)
    noff = len(p.offsets)
    offs = (ctypes.c_int * (3 * noff))(*(v for o in p.offsets for v in o))
    slots = (ctypes.c_int * noff)(*p.slots)
    out = torch.empty_like(x)
    lib = kernels.lib()
    with torch.cuda.device(x.device):
        err = lib.pmg_galerkin_sweep(
            x.data_ptr(), out.data_ptr(), None if b is None else b.data_ptr(), p.fields.data_ptr(),
            p.diag.data_ptr(), *x.shape, noff, offs, slots, p.scalars_at.data_ptr(),
            _twin.f32(omega), _twin.f32(1.0 - omega), _twin.noise_factor(omega, torch.float32),
            _noise.hash_prefix(seed, step, _noise.GALERKIN_DOMAIN), at, backward,
            int(with_noise), torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check_launch(err, "galerkin_sweep", LAUNCHES)
    return out
