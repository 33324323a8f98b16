"""The trilinear prolong-add of the linear-Galerkin cycle, y + P z, in one
pass: CUDA kernel wrapper and twin.

On the way up, every level of the general multigrid cycle on the linear
hierarchy (``MGMCSampler``'s default) adds the prolonged coarse
correction to its state: ``GeometricTransfer.prolong_add(y, z)``, with P
the vertex-style trilinear interpolation of
:func:`parmgmc_tpu_torch.operators.stencil.prolong`.  One call of
:func:`prolong_add` is one launch of ``csrc/prolong_add.cu``:

    out = y + P z        (y, out: the fine 3D grid; z: ceil(n/2) an axis)

into a new tensor, a given contiguous buffer, or y itself (each output
point reads y only at its own index).

The twin (:func:`prolong_add_reference`) is the plain expression the
kernel replaces, ``y + prolong(z, y.shape)``: three passes of
``_prolong_1d`` (axis 0, then 1, then 2) and an add.  The kernel rounds
every operation as those torch ops do, so the two agree bit for bit.  No
TPU kernel computes this: the JAX package leaves the transfers of its
general cycle to XLA.

Bytes bound it: a call reads y and z once and writes its output once
(142.6 MB at 256^3, 42.6 us at 3.35 TB/s).  A thread owns four
consecutive fine points of axis 2 (one 16-byte load of y and one 16-byte
store) and reads the coarse values they need through the read-only path,
z staying in L2; no interpolated temporary reaches device memory.  On an
NVIDIA H100 80GB HBM3 (700 W) a 256^3 call takes 52.45 us (81 % of its
bound) against the twin's 500.4, and a 256^3 V(2,2) step's five calls
67.51 us in a CUDA graph against the twin's 676.4; ``csrc/prolong_add.cu``
has the other levels.
"""

from __future__ import annotations

import math

import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.operators.stencil import coarse_shape, prolong

__all__ = ["takes", "prolong_add", "prolong_add_reference"]


def takes(y, z, fine_shape, out=None) -> bool:
    """Does the kernel take ``y + P z`` on the grid ``fine_shape``?  A 3D
    float32 y of exactly that shape (no chain dims), z of its coarse shape
    on y's device, fewer than 2^31 points, and ``out`` None or a contiguous
    float32 tensor of the grid's shape."""
    fine = tuple(int(s) for s in fine_shape)
    return (len(fine) == 3 and math.prod(fine) < 2**31
            and y.dtype == torch.float32 and tuple(y.shape) == fine
            and z.dtype == torch.float32 and tuple(z.shape) == coarse_shape(fine)
            and z.device == y.device
            and (out is None or (out.dtype == torch.float32 and tuple(out.shape) == fine
                                 and out.is_contiguous())))


def prolong_add_reference(y, z, out=None):
    """Plain-torch twin of :func:`prolong_add` (any device)."""
    return torch.add(y, prolong(z, y.shape), out=out)


def _overlap(a, b) -> bool:
    """Do the storage ranges of two contiguous tensors meet?"""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def prolong_add(y, z, out=None):
    """y + P z on the 3D grid of y, into ``out`` when given (a contiguous
    buffer of y's shape, or y itself).

    CPU tensors run :func:`prolong_add_reference`; CUDA tensors launch
    ``csrc/prolong_add.cu`` (float32, contiguous) or raise."""
    if y.device.type == "cpu":
        return prolong_add_reference(y, z, out=out)
    shape = tuple(y.shape)
    if y.ndim != 3:
        raise ValueError(f"the prolong-add kernel takes a 3D grid, got y of shape {shape}")
    if tuple(z.shape) != coarse_shape(shape):
        raise ValueError(f"z shape {tuple(z.shape)} != the coarse grid {coarse_shape(shape)}")
    if math.prod(shape) >= 2**31:
        raise ValueError("the prolong-add kernel takes grids of fewer than 2^31 points")
    for name, t in (("y", y), ("z", z), ("out", out)):
        if t is not None:
            kernels.check_input(name, t, y)
    if out is None:
        out = torch.empty_like(y)
    elif tuple(out.shape) != shape:
        raise ValueError(f"out shape {tuple(out.shape)} != y's {shape}")
    elif _overlap(out, z) or (out.data_ptr() != y.data_ptr() and _overlap(out, y)):
        raise ValueError("out must be y itself or share no memory with y and z")
    with torch.cuda.device(y.device):
        err = kernels.lib().pmg_prolong_add(y.data_ptr(), z.data_ptr(), out.data_ptr(), *shape,
                                            torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check_launch(err, "prolong_add")
    return out
