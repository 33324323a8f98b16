"""Frozen roofline arithmetic of the marching red/black sweep on the FD
levels of the aggregate hierarchy (``csrc/sweep_march.cu`` in FD mode,
``sweep_march_kernel<false, ...>``: #9, ``fused_rb_gibbs_sweep_2d_staged``,
on planes past the plane limit, #7, ``fused_rb_gibbs_sweep_fd``, below),
in the terms of :mod:`portbench.rooflines`.

A call on an m^3 level reads the state x and the right-hand side b and
writes the swept state; each point draws its noise and takes one update
(the six neighbour terms of the residual, over D, blended by omega).  A
V(n_pre, n_post) step of the general keyed cycle makes n_pre + n_post
calls a smoothed level.  At 768^3 a call moves 5,435,817,984 bytes,
1.6226 ms at the card's peak; the 24 calls of a V(2,2) step on 384^3 ...
12^3 3,106,169,856 bytes, 0.927 ms: both bound by bytes."""

from __future__ import annotations

from portbench import rooflines

# the update of one point: the residual's arithmetic, the division by D
# and omega's blend (1 - omega) x + omega u
UPDATE_OPS = rooflines.RESIDUAL_OPS + 4


def call(m: int) -> tuple:
    """(bytes, ops) of one sweep on an m^3 level."""
    pts = m**3
    return rooflines.F32 * 3 * pts, pts * (rooflines.NOISE_OPS + UPDATE_OPS)


def step(extents: list, sweeps: int) -> list:
    """(bytes, ops) of each call of a step: ``sweeps`` a smoothed level of
    ``extents[:-1]`` (``extents[-1]`` the coarsest, which no sweep takes)."""
    return [call(m) for m in extents[:-1] for _ in range(sweeps)]


def step_bound_s(n: int, coarsest_size: int, sweeps: int) -> float:
    """The least time of a chain step's sweeps on the n^3 hierarchy."""
    return sum(rooflines.bound_s(*c) for c in step(rooflines.levels(n, coarsest_size), sweeps))
