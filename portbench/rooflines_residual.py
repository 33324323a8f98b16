"""Frozen roofline arithmetic of the fused residual and restriction
(``kernels.residual_restrict.residual_restrict``) on the linear-Galerkin
hierarchy of the 7-point link-count GMRF, in the terms of
:mod:`portbench.rooflines`: bytes count each input read once and each
output written once, operations the float32 arithmetic of the plain twin.

A step of the general keyed cycle makes six calls at 256^3: the fine
residual b - A x alone (b = None on the prior: x in, r out), then the
residual and its restriction R (b - A x) on every smoothed level (x and
b in, the coarse field out).  The 7-point level's D is link-count FD,
made from two scalars, and counts no bytes; a 27-point level reads D and
its :data:`~portbench.rooflines_galerkin.FIELDS` coefficient fields."""

from __future__ import annotations

from portbench import rooflines, rooflines_galerkin

FD_OFFSETS = 6
GALERKIN_OFFSETS = 26


def _ops(pts: int, noff: int) -> int:
    """float32 operations of the residual at ``pts`` points: a product and
    a sum an offset, D x, its sum and b minus it."""
    return pts * (2 * noff + 3)


def _restrict_ops(m: int) -> int:
    """float32 operations of the full weighting of an m^3 field: each axis
    pass takes two halves and two sums an output point."""
    c = (m + 1) // 2
    return 4 * (c * m * m + c * c * m + c**3)


def fine_residual(n: int) -> tuple:
    """(bytes, ops) of the fine residual alone at n^3 on the prior."""
    pts = n**3
    return rooflines.F32 * 2 * pts, _ops(pts, FD_OFFSETS) + 2 * pts


def level(m: int, fd: bool) -> tuple:
    """(bytes, ops) of the residual and its restriction on an m^3 level: the
    7-point FD star (``fd``) or a 27-point Galerkin level."""
    pts, coarse = m**3, ((m + 1) // 2) ** 3
    streams = 2 if fd else 3 + rooflines_galerkin.FIELDS
    noff = FD_OFFSETS if fd else GALERKIN_OFFSETS
    return rooflines.F32 * (streams * pts + coarse), _ops(pts, noff) + 2 * fd * pts + _restrict_ops(m)


def calls(n: int, coarsest_size: int) -> list:
    """(bytes, ops) of each call of a step, in the step's order."""
    smoothed = rooflines_galerkin.extents(n, coarsest_size)[:-1]
    return [fine_residual(n)] + [level(m, i == 0) for i, m in enumerate(smoothed)]


def step_bound_s(n: int, coarsest_size: int) -> float:
    """The least time of a chain step's six calls of the kernel."""
    return sum(rooflines.bound_s(*c) for c in calls(n, coarsest_size))
