"""Frozen roofline arithmetic of the from-zero down-phase of the marching
chain kernel (#3, ``mg_sweep.fused_zero_gibbs_restrict_fd``: the x-less
mode of ``csrc/chain_march.cu``), in the terms of
:mod:`portbench.rooflines`.

A call on an m^3 level reads its right-hand side b and writes the sweep y
and the restricted residual R (b - A y) on the (m/2)^3 grid below; it
draws, sweeps, takes the residual and restricts it, the arithmetic of
:func:`rooflines.tail_down` a level.  A V(1,0) step on a hierarchy the
tail refuses makes one call a smoothed level below level 0."""

from __future__ import annotations

from portbench import rooflines


def call(m: int) -> tuple:
    """(bytes, ops) of one call on an m^3 level."""
    pts = m**3
    nbytes = rooflines.F32 * (2 * pts + (m // 2) ** 3)
    ops = pts * (rooflines.NOISE_OPS + rooflines.SWEEP_OPS + rooflines.RESIDUAL_OPS + rooflines.RESTRICT_OPS)
    return nbytes, ops


def zero_restrict(extents: list) -> tuple:
    """(bytes, ops) of a step's calls on the smoothed levels ``extents[:-1]``
    (``extents[-1]`` the coarsest, which no call smooths)."""
    calls = [call(m) for m in extents[:-1]]
    return sum(c[0] for c in calls), sum(c[1] for c in calls)
