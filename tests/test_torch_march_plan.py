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
and work items its rule gives.
"""

import math

import numpy as np
import pytest
import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.kernels import _march, mg_sweep, rb_gibbs

SHAPES = [(768, 768, 768), (32, 768, 768), (12, 770, 772), (12, 770, 774)]
LEVELS = [(384 >> k,) * 3 for k in range(6)]  # 384^3 .. 12^3
# kind: (plan of a shape, axis-0 halo, even segments)
KINDS = {
    "sweep": (rb_gibbs.sweep_plan, 2, False),
    "full": (rb_gibbs.full_sweep_plan, 2, False),
    "chain": (mg_sweep.chain_plan, 3, True),
    "chain_z": (lambda s: mg_sweep.chain_plan(s, with_z=True), 3, True),
}


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
CASES = ([(k, s) for k in KINDS if k != "full" for s in SHAPES] + [("chain", s) for s in LEVELS]
         + [("full", s) for s in FULL])


@pytest.mark.parametrize("kind,shape", CASES)
def test_every_plane_strip_has_one_owner(kind, shape):
    make, halo, even = KINDS[kind]
    p = make(shape)
    n0, n1, n2 = shape
    t1, t2 = p.strip
    assert (p.halo, *p.strip) == kernels.TILES["chain_march" if "chain" in kind else "sweep_march"]
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


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "full"])
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
