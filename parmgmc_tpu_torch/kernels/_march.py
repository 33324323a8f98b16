"""Launch plan of the plane-marching kernels (``csrc/sweep_march.cu``,
``csrc/chain_march.cu``).

A work item is one (T1, T2) column strip of the plane over a segment of
``seg`` planes of axis 0; the kernel runs one block per work item, in the
grid (n2 strips, n1 strips, segments).  A block also streams ``halo``
planes on each side of its segment (2 for the sweep, 3 for the chain),
whose cells it recomputes, and one box of the plane around its strip
(the in-plane halo).  The plan depends on the shape alone, so the twins'
per-item partial sums tile the grid as the kernel does on any device.

Segments are as long as :data:`SEG` planes while the grid still has
:data:`MIN_ITEMS` work items (then the last wave of blocks is under a
tenth of the work on an H100: 132 SMs hold 396 to 528 of these blocks),
and no shorter than :data:`MIN_SEG`; chain segments are even, so that an
aggregate's two planes stay in one item.

The full sweep below the plane limit (#7, #6) runs the same marching body
on grids from 384^3 down to 12^3, where those rules leave most of the
card idle.  :func:`full_plan` cuts axis 0 into about
:data:`FULL_SEGMENTS` segments of at least 2 planes, whatever the rest of
the shape: of the segment lengths the ``sweep-plans`` drive of
``time_main_path.py`` timed on an H100 at every level of the 256^3 and
768^3 V(2,2) hierarchies, that one was the fastest at 9 of 12 shapes and
within 15 % at the others; strips of 16 or 8 rows and a target count of
work items did no better.

The chain's level 0 below the plane limit (#1) recomputes four r~ planes a
segment, so short segments cost it more than they cost the sweep.
:func:`wave_plan` cuts each strip's column of planes into as few even
segments as still give every one of :data:`SLOTS` block slots an item,
so the launch runs in one wave (the ``chain-plans`` drive of
``time_main_path.py`` timed each segment length at 256^3 and (16, 24,
96)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "SEG", "MIN_SEG", "MIN_ITEMS", "FULL_SEGMENTS", "SLOTS", "MarchPlan", "plan", "full_plan",
    "wave_plan",
]

SEG = 96  # longest segment: 6 halo planes cost the chain 6 % of its x loads
MIN_SEG = 16  # shortest segment, whose halo planes already add 25 % (sweep) or 37 % (chain)
MIN_ITEMS = 4096  # work items wanted before segments get shorter
FULL_SEGMENTS = 20  # segments of axis 0 a full sweep (#7, #6) is cut into
SLOTS = 3 * 132  # block slots of a 32-row chain launch: 3 blocks on each of an H100's 132 SMs


@dataclass(frozen=True)
class MarchPlan:
    """Geometry of one marching launch."""

    shape: tuple  # (n0, n1, n2)
    strip: tuple  # (T1, T2)
    halo: int  # axis-0 halo planes streamed on each side of a segment
    seg: int  # planes a work item owns (the last segment may be shorter)
    tma: bool  # stream with TMA (else with cp.async)

    @property
    def grid(self) -> tuple:
        """(segments, n1 strips, n2 strips): the partial sums' tile grid,
        in the kernels' block order."""
        n0, n1, n2 = self.shape
        return (-(-n0 // self.seg), -(-n1 // self.strip[0]), -(-n2 // self.strip[1]))

    @property
    def tile(self) -> tuple:
        """(seg, T1, T2): the block of the grid one work item owns."""
        return (self.seg, *self.strip)

    @property
    def items(self) -> int:
        return math.prod(self.grid)

    def item(self, w: int) -> dict:
        """Work item ``w`` (block order): the planes, rows and columns it
        owns, as half-open ranges clipped to the grid, and the planes it
        streams."""
        g0, g1, g2 = self.grid
        s, r = divmod(w, g1 * g2)
        a, c = divmod(r, g2)
        n0, n1, n2 = self.shape
        lo = s * self.seg
        hi = min(lo + self.seg, n0)
        return dict(
            planes=(lo, hi),
            rows=(a * self.strip[0], min((a + 1) * self.strip[0], n1)),
            cols=(c * self.strip[1], min((c + 1) * self.strip[1], n2)),
            streamed=(lo - self.halo, hi + self.halo),
        )


def plan(shape, halo: int, strip=(32, 32), *, even: bool = False, row_words=()) -> MarchPlan:
    """The plan of a marching launch on a grid of ``shape``.

    ``halo`` and ``strip`` are the kernel's (``kernels.TILES``); ``even``
    asks for even segments (the chain).  ``row_words`` are the row lengths,
    in float32 words, of every tensor the launch streams: TMA takes them
    when each is a multiple of 4 (a row stride of 16 B), cp.async
    otherwise."""
    n0, n1, n2 = (int(s) for s in shape)
    strips = -(-n1 // strip[0]) * -(-n2 // strip[1])
    seg = min(SEG, max(MIN_SEG, n0 * strips // MIN_ITEMS))
    if even:
        seg -= seg % 2
    return MarchPlan(
        shape=(n0, n1, n2), strip=tuple(strip), halo=halo, seg=seg,
        tma=all(int(w) % 4 == 0 for w in row_words),
    )


def full_plan(shape, halo: int, strip=(32, 32), *, row_words=()) -> MarchPlan:
    """The plan of a full sweep (#7, #6) on a grid of ``shape``: segments
    of ``n0 // FULL_SEGMENTS`` planes, at least 2.  ``halo``, ``strip``
    and ``row_words`` as for :func:`plan`."""
    n0, n1, n2 = (int(s) for s in shape)
    return MarchPlan(
        shape=(n0, n1, n2), strip=tuple(strip), halo=halo, seg=max(2, n0 // FULL_SEGMENTS),
        tma=all(int(w) % 4 == 0 for w in row_words),
    )


def wave_plan(shape, halo: int, strip=(32, 32), *, row_words=(), slots=SLOTS) -> MarchPlan:
    """The plan of #1 on a grid of ``shape``: even segments, as long as
    still gives each of ``slots`` block slots a work item, between 2 and
    :data:`SEG` planes (a grid with fewer strips than slots has 2-plane
    segments; one with more strips than slots, :data:`SEG`-plane ones).
    ``halo``, ``strip`` and ``row_words`` as for :func:`plan`."""
    n0, n1, n2 = (int(s) for s in shape)
    strips = -(-n1 // strip[0]) * -(-n2 // strip[1])
    seg = -(-n0 // max(1, slots // strips))
    return MarchPlan(
        shape=(n0, n1, n2), strip=tuple(strip), halo=halo, seg=min(SEG, max(2, seg + seg % 2)),
        tma=all(int(w) % 4 == 0 for w in row_words),
    )
