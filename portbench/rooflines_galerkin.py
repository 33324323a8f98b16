"""Frozen roofline arithmetic of the 27-point colour sweep
(``kernels.galerkin_sweep.fused_galerkin_sweep``) on the linear-Galerkin
hierarchy of the 7-point link-count GMRF, in the terms of
:mod:`portbench.rooflines`: bytes count each input read once and each
output written once, operations the float32 arithmetic of the plain twin.

A half-sweep of an m^3 level reads x, b, D and each grid-shaped
coefficient field once and writes x once.  Of the 26 offsets of such a
level, :data:`FIELDS` carry a field; the eight corners are one scalar
where their neighbour exists (read off the 256^3 hierarchy; a test holds
the count against the reference's own Galerkin operators)."""

from __future__ import annotations

from portbench import rooflines

FIELDS = 18
# float32 operations a point: the 26 neighbour products and their 25 sums,
# b~ minus the sum (1), 1/D and its product with omega (2), (1 - omega) x,
# the update's product and its sum (3), the draw with its scale and add
OPS = 26 + 25 + 1 + 2 + 3 + rooflines.NOISE_OPS


def extents(n: int, coarsest_size: int) -> list:
    """Extents of the linear hierarchy of an n^3 grid: ceil(m/2) an axis
    while the next grid keeps ``coarsest_size`` points and m > 2."""
    out = [n]
    while ((out[-1] + 1) // 2) ** 3 >= coarsest_size and out[-1] > 2:
        out.append((out[-1] + 1) // 2)
    return out


def half_sweep(m: int) -> tuple:
    """(bytes, ops) of one half-sweep of an m^3 27-point level."""
    pts = m**3
    return rooflines.F32 * pts * (2 + 1 + 1 + FIELDS), pts * OPS


def step_bound_s(n: int, coarsest_size: int, sweeps: int) -> float:
    """The least time of a chain step's half-sweeps of the kernel: ``sweeps``
    (n_pre + n_post) on every 27-point level, those between level 0 and
    the coarsest."""
    return sum(sweeps * rooflines.bound_s(*half_sweep(m)) for m in extents(n, coarsest_size)[1:-1])
