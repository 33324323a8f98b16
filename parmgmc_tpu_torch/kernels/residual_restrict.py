"""The residual of a 3D radius-1 stencil and its full-weighting
restriction, fused: CUDA kernel wrapper and twin.

A level of the general multigrid cycle on the linear hierarchy
(``MGMCSampler``'s default) hands its coarse level R (b - A x), with R
the full weighting of :class:`~parmgmc_tpu_torch.operators.transfer.
GeometricTransfer`; the chain step also needs the fine residual b - A x
alone (level 0's right-hand side).  One call of :func:`residual_restrict`
is either, in one launch of ``csrc/residual_restrict.cu``:

    restrict=True:   R (b - A x)      (coarse, ceil(n/2) an axis)
    restrict=False:  b - A x          (fine)

with b None a zero right-hand side.  A is any 3D radius-1
:class:`~parmgmc_tpu_torch.operators.stencil.StencilOperator` in float32:
the 7-point FD star of level 0 and the 27-point Galerkin levels below
it, each coefficient a scalar or a grid field.  The kernel reads D as a
field or, where the operator is in link-count FD form (and rebuilding D
from (kappa2, hinv2) gives its stored bits), makes it in registers.

The twin (:func:`residual_restrict_reference`) is the plain expression
the kernel replaces, ``restrict(b - A.apply(x))``; the kernel rounds
every operation as its torch ops do, so the two agree bit for bit.  No
TPU kernel computes this: the JAX package leaves its residuals and
transfers to XLA.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.operators.stencil import (
    FDStencilOperator,
    StencilOperator,
    coarse_shape,
    detect_fd_params,
    link_count,
    restrict as restrict_full,
)
from parmgmc_tpu_torch.operators.transfer import GeometricTransfer

__all__ = ["Pack", "pack", "supported", "takes", "residual_restrict", "residual_restrict_reference"]

MAX_OFF = kernels.MAX_OFF


def _stencil(op) -> bool:
    """A 3D radius-1 stencil (not LRC, not a graph)."""
    return (isinstance(op, StencilOperator) and op.ndim == 3 and op.radius == 1
            and len(op.offsets) <= MAX_OFF)


def supported(op, transfer) -> bool:
    """Does the kernel take the level (``op``, ``transfer``)?  A 3D radius-1
    stencil in float32 coarsened by the linear transfer of its own grid."""
    return (_stencil(op) and op.dtype == torch.float32 and isinstance(transfer, GeometricTransfer)
            and tuple(transfer.fine_shape) == tuple(op.grid_shape))


def takes(op, x, b=None) -> bool:
    """Does a call on a supported ``op`` take the state ``x`` and the
    right-hand side ``b``?  x in float32 on the grid with no chain dims, b
    None or of the grid's shape."""
    grid = tuple(op.grid_shape)
    return (x.dtype == torch.float32 and tuple(x.shape) == grid
            and (b is None or tuple(b.shape) == grid))


@dataclass(frozen=True, eq=False)
class Pack:
    """What the kernel reads of an operator besides x and b: each offset,
    its coefficient field (None: a scalar) and scalar (float32 value, 0.0
    where a field), the scalars again in device memory (``scalars_at``,
    :data:`MAX_OFF` floats), and D as a field or, with ``diag`` None, the
    FD scalars ``fd`` = (kappa2, hinv2)."""

    offsets: tuple
    fields: tuple
    scalars: tuple
    scalars_at: torch.Tensor
    diag: "torch.Tensor | None"
    fd: tuple


def _fd_diag(op) -> "tuple | None":
    """(kappa2, hinv2) whose float32 kappa2 + hinv2 * links is the
    operator's D bit for bit, or None (D is read as a field)."""
    if isinstance(op, FDStencilOperator):
        return op.fd_params()
    fd = detect_fd_params(op)
    if fd is None:
        return None
    k2, h2 = (torch.tensor(v, dtype=torch.float32, device=op.device) for v in fd)
    if not torch.equal(k2 + h2 * link_count(op.grid_shape, torch.float32, op.device), op.diag):
        return None
    return float(k2), float(h2)


def pack(op: StencilOperator) -> Pack:
    """The kernel's view of ``op`` (set-up: reads the scalars to the host;
    the fields are the operator's own tensors)."""
    fields, scalars = [], []
    for c in op.coeffs:
        if c.ndim == 0:
            fields.append(None)
            scalars.append(float(c.to(torch.float32)))
        else:
            fields.append(c.contiguous())
            scalars.append(0.0)
    fd = _fd_diag(op)
    return Pack(offsets=tuple(tuple(int(v) for v in o) for o in op.offsets), fields=tuple(fields),
                scalars=tuple(scalars), scalars_at=kernels.scalar_array(scalars, op.device),
                diag=None if fd is not None else op.diag.contiguous(),
                fd=fd if fd is not None else (0.0, 0.0))


def residual_restrict_reference(x, b, op, *, restrict=True):
    """Plain-torch twin of :func:`residual_restrict` (any device)."""
    r = (torch.zeros_like(x) if b is None else b) - op.apply(x)
    return restrict_full(r, 3) if restrict else r


def residual_restrict(x, b, op, *, restrict=True, packed=None):
    """R (b - A x) (``restrict``) or b - A x for the 3D stencil ``op``.

    CPU tensors run :func:`residual_restrict_reference`; CUDA tensors
    launch ``csrc/residual_restrict.cu`` (float32, contiguous) or raise.
    ``packed`` is :func:`pack` of ``op`` (made here when not given: a
    sampler keeps its own)."""
    if x.device.type == "cpu":
        return residual_restrict_reference(x, b, op, restrict=restrict)
    if not _stencil(op):
        raise ValueError("the residual kernel takes a 3D radius-1 stencil")
    shape = tuple(op.grid_shape)
    if tuple(x.shape) != shape:
        raise ValueError(f"x shape {tuple(x.shape)} != the operator's grid {shape}")
    if b is not None and tuple(b.shape) != shape:
        raise ValueError(f"b shape {tuple(b.shape)} != the operator's grid {shape}")
    if math.prod(shape) >= 2**31:
        raise ValueError("the residual kernel takes grids of fewer than 2^31 points")
    p = pack(op) if packed is None else packed
    for name, t in (("x", x), ("b", b), ("diag", p.diag), ("scalars_at", p.scalars_at),
                    *(("field", f) for f in p.fields)):
        if t is not None:
            kernels.check_input(name, t, x)
    noff = len(p.offsets)
    offs = (ctypes.c_int * (3 * noff))(*(v for o in p.offsets for v in o))
    fields = (ctypes.c_void_p * max(noff, 1))(*(None if f is None else f.data_ptr() for f in p.fields))
    scal = (ctypes.c_float * max(noff, 1))(*p.scalars)
    out = torch.empty(coarse_shape(shape) if restrict else shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = kernels.lib().pmg_residual_restrict(
            x.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), fields, scal,
            p.scalars_at.data_ptr(), offs,
            noff, None if p.diag is None else p.diag.data_ptr(), p.fd[0], p.fd[1], *shape,
            int(restrict), torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check_launch(err, "residual_restrict")
    return out
