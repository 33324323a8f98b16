"""The launch plan of the plane-marching kernels (``kernels/_march.py``), on the CPU.

At the shapes the large-plane paths run -- 768^3, bench.py selftest2d's
(32, 768, 768), ``chip_smoke.py``'s ragged plane (12, 770, 772), a plane
whose rows are not a multiple of 16 B (12, 770, 774), and the six levels
below 0 of the 768^3 hierarchy that #3 runs -- every (plane, strip) has
exactly one owner, a work item streams its own planes and the halo planes
around them and no others, chain segments start on even planes, the
streamed halo costs at most 6.25 % at 768^3, the last wave of blocks is
under a tenth of the work there, and the producer is TMA exactly where
every streamed row is a multiple of 16 B.  The full sweep below the plane
limit (#7, #6) plans every level of the 256^3 and 768^3 V(2,2)
hierarchies and the ragged (16, 24, 96) the same way, with the segments
and work items its rule gives.  So do the chain's level 0 below the plane
limit (#1: 256^3, (16, 24, 96), (10, 6, 34)) on even segments, and its
twin sums per work item.  The tail kernel (#2) runs one cooperative grid
over every level: the blocks it asks for and where each level's outputs
lie in its one buffer.
"""

import math

import numpy as np
import pytest
import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.kernels import _march, mg_sweep, mg_tail, rb_gibbs

SHAPES = [(768, 768, 768), (32, 768, 768), (12, 770, 772), (12, 770, 774)]
LEVELS = [(384 >> k,) * 3 for k in range(6)]  # 384^3 .. 12^3
# kind: (plan of a shape, axis-0 halo, even segments)
KINDS = {
    "sweep": (rb_gibbs.sweep_plan, 2, False),
    "full": (rb_gibbs.full_sweep_plan, 2, False),
    "chain": (mg_sweep.chain_plan, 3, True),
    "chain_z": (lambda s: mg_sweep.chain_plan(s, with_z=True), 3, True),
    "chain_fd": (lambda s: mg_sweep.chain_fd_plan(s, with_z=True), 3, True),
}
# #1 (the chain's level 0 below the plane limit): (segment, work items)
CHAIN_FD = {(256,) * 3: (44, 384), (128,) * 3: (6, 352), (16, 24, 96): (2, 24), (10, 6, 34): (2, 10),
            (768,) * 3: (96, 4608)}  # phase 13 of chip_smoke.py holds #1 against #5 at 768^3



@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# the marching sweep runs only level 0 (past the plane limit); the chain
# kernel level 0 (with the carry z) and, as #3, the levels below it
# the full sweep (#7, #6): every smoothed level of the 256^3 and 768^3 V(2,2)
# hierarchies below the plane limit, and a ragged shape; (segment, work
# items) of the plan: segments of n0 // 20 planes, at least 2
FULL = {
    (256,) * 3: (12, 1408), (128,) * 3: (6, 352), (64,) * 3: (3, 88), (32,) * 3: (2, 16),
    (16,) * 3: (2, 8), (384,) * 3: (19, 3024), (192,) * 3: (9, 792), (96,) * 3: (4, 216),
    (48,) * 3: (2, 96), (24,) * 3: (2, 12), (12,) * 3: (2, 6), (16, 24, 96): (2, 24),
}
CASES = ([(k, s) for k in ("sweep", "chain", "chain_z") for s in SHAPES]
         + [("chain", s) for s in LEVELS] + [("full", s) for s in FULL]
         + [("chain_fd", s) for s in CHAIN_FD])


@pytest.mark.parametrize("kind,shape", CASES)
def test_every_plane_strip_has_one_owner(kind, shape):
    make, halo, even = KINDS[kind]
    p = make(shape)
    n0, n1, n2 = shape
    t1, t2 = p.strip
    tile = kernels.TILES["chain_march" if "chain" in kind else "sweep_march"]
    assert (p.halo, *p.strip) == tile
    assert p.halo == halo
    g0, g1, g2 = p.grid
    assert (g1, g2) == (-(-n1 // t1), -(-n2 // t2)) and p.items == g0 * g1 * g2
    owners = np.zeros((n0, g1 * g2), np.int32)
    for w in range(p.items):
        it = p.item(w)
        lo, hi = it["planes"]
        (r0, r1), (c0, c1) = it["rows"], it["cols"]
        assert 0 <= lo < hi <= n0 and hi - lo <= p.seg
        assert r0 % t1 == 0 and c0 % t2 == 0 and r0 < r1 <= n1 and c0 < c1 <= n2
        assert r1 - r0 == min(t1, n1 - r0) and c1 - c0 == min(t2, n2 - c0)
        # the streamed planes are the item's own and `halo` on each side
        assert it["streamed"] == (lo - halo, hi + halo)
        if even:
            assert lo % 2 == 0 and hi % 2 == 0
        owners[lo:hi, (r0 // t1) * g2 + c0 // t2] += 1
    assert (owners == 1).all()


@pytest.mark.parametrize("kind", ["sweep", "chain", "chain_z"])
def test_segments_fill_the_card_at_768(kind):
    make, halo, _ = KINDS[kind]
    p = make((768,) * 3)
    assert p.items >= _march.MIN_ITEMS and p.seg == _march.SEG
    streamed = sum(b - a for a, b in (p.item(w)["streamed"] for w in range(p.grid[0])))
    assert streamed / 768 <= 1.0625  # the axis-0 halo recompute
    for slots in (3 * 132, 4 * 132):  # 3 or 4 blocks on each of the H100's 132 SMs
        waves = p.items / slots
        assert (math.ceil(waves) - waves) / math.ceil(waves) < 0.1


@pytest.mark.parametrize("shape", list(FULL))
def test_full_sweep_plan_at_every_level(shape):
    p = rb_gibbs.full_sweep_plan(shape)
    seg, items = FULL[shape]
    assert p.seg == seg == max(2, shape[0] // _march.FULL_SEGMENTS)
    assert p.items == items and p.strip == tuple(kernels.TILES["sweep_march"][1:])
    assert p.tma == (shape[2] % 4 == 0)
    # the 256^3 and 384^3 levels fill 3 blocks on each of the H100's 132 SMs
    # several times over; the latency-bound small levels keep 2-plane segments
    waves = p.items / (3 * 132)
    if shape[0] >= 256:
        assert waves >= 3
    if shape[0] <= 48:
        assert p.seg == 2
    assert rb_gibbs.full_sweep_plan(list(shape)) is p  # kept per shape


@pytest.mark.parametrize("n2", [768, 772, 774, 770, 776, 36, 34])
def test_producer_follows_the_row_stride(n2):
    shape = (12, 40, n2)
    assert rb_gibbs.sweep_plan(shape).tma == (n2 % 4 == 0)
    assert rb_gibbs.full_sweep_plan(shape).tma == (n2 % 4 == 0)
    assert mg_sweep.chain_plan(shape).tma == (n2 % 4 == 0)
    # the compact carry z has rows of n2 / 2 words
    assert mg_sweep.chain_plan(shape, with_z=True).tma == (n2 % 8 == 0)


def test_short_grids_keep_the_minimum_segment():
    # few strips: segments shorten to MIN_SEG planes, never below
    for shape in [(32, 768, 768), (384,) * 3, (48,) * 3]:
        assert mg_sweep.chain_plan(shape).seg == _march.MIN_SEG
    assert mg_sweep.chain_plan((12, 770, 772)).grid[0] == 1


def test_twin_partial_sums_follow_the_plan():
    shape = (36, 40, 70)  # three segments of 16, 16 and 4 planes
    p = mg_sweep.chain_plan(shape)
    assert p.grid == (3, 2, 3)
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    z = torch.from_numpy(rs.randn(*(s // 2 for s in shape)).astype(np.float32))
    args = ([-1225.0] * 6, 1.0, 1225.0, 1.0, 3, 5)
    for fn in (mg_sweep.fused_chain_down_2d_staged, mg_sweep.fused_chain_down_2d):
        xpy, _, xs, zs = fn(x, None, *args, z=z, with_xsum=True, with_zsum=True)
        assert xs.shape == zs.shape == (p.items,)
        w = 7  # segment 1, row strip 0, column strip 1
        it = p.item(w)
        (lo, hi), (r0, r1), (c0, c1) = it["planes"], it["rows"], it["cols"]
        want = xpy[lo:hi, r0:r1, c0:c1].double().sum()
        assert abs(float(xs[w]) - float(want)) <= 1e-4 * float(xpy.abs().sum())
        zw = z[lo // 2:hi // 2, r0 // 2:r1 // 2, c0 // 2:c1 // 2].double().sum()
        assert abs(float(zs[w]) - float(zw)) <= 1e-4 * float(z.abs().sum())


@pytest.mark.parametrize("shape", list(CHAIN_FD))
def test_chain_fd_plan(shape):
    """#1's plan: the longest even segments that still give all 396 block
    slots (3 blocks on each of the H100's 132 SMs) an item, so the launch
    is one wave, and 2-plane segments where the grid has fewer items than
    slots; the expected work items; kept per shape; TMA where the rows of
    x (n2) and z (n2 / 2) allow it."""
    p = mg_sweep.chain_fd_plan(shape, with_z=True)
    seg, items = CHAIN_FD[shape]
    assert (p.seg, p.items) == (seg, items) and p.seg % 2 == 0
    assert (p.halo, *p.strip) == kernels.TILES["chain_march"]
    assert p.tma == (shape[2] % 8 == 0)
    assert mg_sweep.chain_fd_plan(list(shape), with_z=True) is p
    assert _march.SLOTS == 3 * 132
    if p.seg == _march.SEG:  # more strips than slots: the long segments of #5's plan
        assert p.seg == mg_sweep.chain_plan(shape).seg
        return
    assert p.items <= _march.SLOTS
    if p.seg > 2:  # two planes fewer a segment would need a second wave
        shorter = _march.MarchPlan(shape=p.shape, strip=p.strip, halo=p.halo, seg=p.seg - 2, tma=p.tma)
        assert shorter.items > _march.SLOTS


# the tail kernel's hierarchies: the 256^3 V(1,0) tail, and the ragged ones
# of tests/test_torch_cuda.py, with the blocks their largest phase asks for
TAIL = {
    ((128,) * 3, (64,) * 3, (32,) * 3, (16,) * 3, (8,) * 3): 2048,
    ((20, 12, 36), (10, 6, 18), (5, 3, 9)): 15,
    ((64, 48, 80), (32, 24, 40), (16, 12, 20), (8, 6, 10), (4, 3, 5)): 384,
    ((2, 2, 96), (1, 1, 48)): 3,  # more tiles (3) than noise blocks (1)
}


@pytest.mark.parametrize("shapes", list(TAIL))
def test_tail_schedule(shapes):
    """#2's one launch: blocks for the largest phase (the first level's
    noise, 16 warps a block and 64 cells of a row a warp, or a level's
    tiles of 8 x 16 x 32 cells, a block each: the 256^3 tail asks for
    more than the H100 keeps resident, so the grid is the card's), and
    one buffer holding every level's scratch, y and rc at disjoint 128-B
    aligned offsets, the coarse RHS last."""
    assert mg_tail.tail_blocks(shapes) == TAIL[shapes]
    lay = mg_tail._layout(shapes)
    assert lay.nlev == len(shapes) - 1 <= mg_tail.MAX_LEVELS and lay.blocks == TAIL[shapes]
    spans = []
    for li, (fine, coarse) in enumerate(zip(shapes[:-1], shapes[1:])):
        for off, shp in zip(lay.off[3 * li:3 * li + 3], (fine, fine, coarse)):
            assert off % 32 == 0
            spans.append((off, off + math.prod(shp)))
    assert lay.views == [(lay.off[3 * li + 1], s) for li, s in enumerate(shapes[:-1])]
    assert lay.rhs == (lay.off[-1], shapes[-1])
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(spans, spans[1:])) and spans[-1][1] <= lay.total
    assert list(lay.shapes) == [n for s in shapes for n in s]


@pytest.mark.parametrize("shape", [(16, 24, 96), (10, 6, 34)])
def test_chain_fd_twin_sums_follow_the_plan(shape):
    """#1's twin returns one partial sum of xpy and of z a work item of
    chain_fd_plan: each is its item's block sum, and they add up to the
    totals."""
    p = mg_sweep.chain_fd_plan(shape)
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    z = torch.from_numpy(rs.randn(*(s // 2 for s in shape)).astype(np.float32))
    h = float((shape[0] - 1) ** 2)
    xpy, _, xs, zs = mg_sweep.fused_chain_down_fd(x, None, [-h] * 6, 1.0, h, 1.3, 3, 5, z=z,
                                                  with_xsum=True, with_zsum=True)
    assert xs.shape == zs.shape == (p.items,)
    for w in range(p.items):
        it = p.item(w)
        (lo, hi), (r0, r1), (c0, c1) = it["planes"], it["rows"], it["cols"]
        want = xpy[lo:hi, r0:r1, c0:c1].double().sum()
        assert abs(float(xs[w]) - float(want)) <= 1e-5 * float(xpy.abs().sum())
        zw = z[lo // 2:hi // 2, r0 // 2:r1 // 2, c0 // 2:c1 // 2].double().sum()
        assert abs(float(zs[w]) - float(zw)) <= 1e-5 * float(z.abs().sum())
    assert abs(float(xs.double().sum()) - float(xpy.double().sum())) <= 1e-5 * float(xpy.abs().sum())
    assert abs(float(zs.double().sum()) - float(z.double().sum())) <= 1e-5 * float(z.abs().sum())
