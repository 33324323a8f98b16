"""Frozen roofline arithmetic of the fused prolong-add
(``kernels.prolong_add.prolong_add``, ``csrc/prolong_add.cu``) on the
linear hierarchy of an n^3 grid, in the terms of :mod:`portbench.rooflines`:
bytes count each input read once and each output written once,
operations the float32 arithmetic of the plain twin.

A step of the general keyed cycle makes one call a smoothed level, on the
way up: y + P z with y on the level (m^3, read) and z on the next (read),
the output on the level (written).  At 256^3 the five calls move
162,973,696 bytes, 48.65 us at the card's peak: bound by bytes."""

from __future__ import annotations

from portbench import rooflines, rooflines_galerkin


def _pass_ops(nf: int) -> int:
    """float32 operations of one axis pass of the interpolation a line of
    ``nf`` fine nodes: a sum and a half an interior odd node, two halves
    and a sum at the last odd node of an even extent."""
    return 2 * ((nf - 1) // 2) + 3 * (nf % 2 == 0)


def call(m: int) -> tuple:
    """(bytes, ops) of y + P z on an m^3 level: the three passes (axis 0
    on c^2 lines, axis 1 on m c, axis 2 on m^2) and the add."""
    c = (m + 1) // 2
    pts = m**3
    ops = (c * c + m * c + m * m) * _pass_ops(m) + pts
    return rooflines.F32 * (2 * pts + c**3), ops


def calls(n: int, coarsest_size: int) -> list:
    """(bytes, ops) of each call of a step, from level 0 down to the level
    above the coarsest (a step runs them in the reverse order)."""
    return [call(m) for m in rooflines_galerkin.extents(n, coarsest_size)[:-1]]


def step_bound_s(n: int, coarsest_size: int) -> float:
    """The least time of a chain step's calls of the kernel."""
    return sum(rooflines.bound_s(*c) for c in calls(n, coarsest_size))
