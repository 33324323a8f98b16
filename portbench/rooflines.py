"""Frozen roofline arithmetic: the published peaks of one NVIDIA H100 SXM
and, for each kernel function a metric reads, the bytes it must move and
the float32 operations it must do at a cell's shapes.

Bytes count each input byte read once and each output byte written once,
whatever the kernel reads again.  Operations count float32 arithmetic
only (the counter hash behind each draw is integer work); a
transcendental counts as one operation.  The bound of a call is the
larger of bytes over the peak bandwidth and operations over the peak
rate."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
F32 = 4

# float32 operations a grid point, read off the plain arithmetic:
# the residual b - (D x + six neighbour terms)
RESIDUAL_OPS = 14
# one N(0, 1) draw and its scale sqrt(D) nscale: the uniforms (3), log,
# sqrt and -2 (3), the fold and the degree-11 polynomial (17), the
# product (1), the scale and the add (4)
NOISE_OPS = 28
# the from-zero red/black sweep: red w b (1); black w (b - neighbours) (14)
SWEEP_OPS = 15
# 2x2x2 block sums: seven adds per eight points
RESTRICT_OPS = 1


def levels(n: int, coarsest_size: int) -> list:
    """Extents of the aggregate hierarchy of an n^3 grid: halve while the
    next grid keeps ``coarsest_size`` points."""
    out = [n]
    while (out[-1] // 2) ** 3 >= coarsest_size and out[-1] > 2:
        out.append(out[-1] // 2)
    return out


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS)


def chain_down_fd(n: int, with_b: bool, with_z: bool) -> tuple:
    """(bytes, ops) of one level-0 chain call on an n^3 grid: reads x (and
    b, and the coarse carry z), writes x + y and the restricted residual;
    the carry's add, the residual twice (before and after the sweep), the
    draw, the sweep, the update and the restriction."""
    pts, coarse = n**3, (n // 2) ** 3
    nbytes = F32 * (pts * (2 + with_b) + coarse * (1 + with_z))
    ops = pts * (with_z + 2 * RESIDUAL_OPS + NOISE_OPS + SWEEP_OPS + 1 + RESTRICT_OPS)
    return nbytes, ops


def tail_down(extents: list) -> tuple:
    """(bytes, ops) of one tail call over the smoothed levels ``extents[:-1]``
    down to the coarsest ``extents[-1]``: reads the first level's
    right-hand side, writes every level's sweep and the coarsest
    right-hand side; a level draws, sweeps, takes its residual and
    restricts it."""
    smoothed = [e**3 for e in extents[:-1]]
    nbytes = F32 * (smoothed[0] + sum(smoothed) + extents[-1] ** 3)
    ops = sum(smoothed) * (NOISE_OPS + SWEEP_OPS + RESIDUAL_OPS + RESTRICT_OPS)
    return nbytes, ops
