"""The factorised schedule of the patch sweeps (``kernels/patch_sweep.py``,
``patch_schedule``), on the CPU.

A patch writes within L1 distance 1 of its centre and reads within 3, so
two patches interact only if their centres are at most 4 apart.  The
kernels (#10, #11) run the 125-colour order as 25 phases (a0, a1) of
independent (i, j) lines of axis 2, each line running its colours a2 = 0
.. 4 in turn.  These tests check the fact that makes that order the colour
order's (interacting centres of one phase share a line), that the
schedule updates every centre once and keeps every interacting pair in
colour order, and that a plain-torch run of the schedule, line by line,
equals the colour-ordered twin bit for bit in float64.
"""

import itertools

import numpy as np
import pytest
import torch

from parmgmc_tpu_torch.kernels import patch_sweep as ps

SHAPES = [(11, 12, 13), (15, 15, 15), (7, 20, 9)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _order(sched):
    """Every centre (i, j, k) in the order the schedule updates it: phases
    in turn, lines in block order, colours in turn on a line."""
    return [(i, j, k) for ph in sched.phases for (i, j) in ph.lines for ks in ph.centres for k in ks]


def _pairs(shape):
    """(p, q) flat indices of every ordered pair of distinct grid points at
    L1 distance <= 4, and the points' coordinates."""
    pts = np.stack(np.meshgrid(*(np.arange(n) for n in shape), indexing="ij"), -1).reshape(-1, 3)
    offs = [o for o in itertools.product(range(-4, 5), repeat=3) if 0 < sum(map(abs, o)) <= 4]
    ps_, qs = [], []
    for o in offs:
        q = pts + np.array(o)
        ok = ((q >= 0) & (q < np.array(shape))).all(1)
        ps_.append(np.nonzero(ok)[0])
        qs.append(np.ravel_multi_index(q[ok].T, shape))
    return np.concatenate(ps_), np.concatenate(qs), pts


@pytest.mark.parametrize("shape", SHAPES)
def test_interacting_centres_of_a_phase_share_a_line(shape):
    p, q, pts = _pairs(shape)
    a, c = pts[p] % 5, pts[q] % 5
    same_a0 = a[:, 0] == c[:, 0]
    # centres with the same a0 within distance 4 lie in one plane of axis 0
    assert (pts[p][same_a0, 0] == pts[q][same_a0, 0]).all()
    # with the same (a0, a1), on one (i, j) line of axis 2
    phase = same_a0 & (a[:, 1] == c[:, 1])
    assert phase.any()
    assert (pts[p][phase, :2] == pts[q][phase, :2]).all()


@pytest.mark.parametrize("shape", SHAPES + [(5, 5, 5), (1, 1, 4), (6, 1, 11)])
def test_schedule_covers_every_centre_once(shape):
    sched = ps.patch_schedule(shape)
    assert sched.shape == shape
    assert [(ph.a0, ph.a1) for ph in sched.phases] == [(a0, a1) for a0 in range(5) for a1 in range(5)]
    order = _order(sched)
    assert sorted(order) == sorted(itertools.product(*(range(n) for n in shape)))
    for ph in sched.phases:
        for i, j in ph.lines:
            assert (i % 5, j % 5) == (ph.a0, ph.a1) and i < shape[0] and j < shape[1]
        for a2, ks in enumerate(ph.centres):
            assert all(k % 5 == a2 and k < shape[2] for k in ks)


@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_keeps_interacting_pairs_in_colour_order(shape):
    sched = ps.patch_schedule(shape)
    pos = np.empty(shape, np.int64)
    for t, c in enumerate(_order(sched)):
        pos[c] = t
    p, q, pts = _pairs(shape)
    a, c = pts[p] % 5, pts[q] % 5
    colour_p = 25 * a[:, 0] + 5 * a[:, 1] + a[:, 2]
    colour_q = 25 * c[:, 0] + 5 * c[:, 1] + c[:, 2]
    flat = pos.reshape(-1)
    differ = colour_p != colour_q  # same-colour centres never interact
    assert ((colour_p < colour_q) == (flat[p] < flat[q]))[differ].all()


@pytest.mark.parametrize("shape", [(256, 256, 256), (128, 128, 128), (11, 12, 13)])
def test_lines_in_the_kernels_block_order(shape):
    # block l of phase (a0, a1) takes line (a0 + 5p, a1 + 5q), l = p nq + q
    sched = ps.patch_schedule(shape)
    for ph in sched.phases:
        nq = len(range(ph.a1, shape[1], 5))
        assert len(ph.lines) == len(range(ph.a0, shape[0], 5)) * nq
        for line_no, (i, j) in enumerate(ph.lines):
            p, q = divmod(line_no, nq)
            assert (i, j) == (ph.a0 + 5 * p, ph.a1 + 5 * q)
    assert ps.patch_schedule(list(shape)) is sched  # kept per shape


def _schedule_emulation(x, b, kappa2, hinv2, seed, step, with_noise):
    """The sweep in the schedule's order, a line's colour at a time."""
    twin = ps._PatchTwin(x, b, kappa2, hinv2, seed, step, with_noise)
    for ph in ps.patch_schedule(tuple(x.shape)).phases:
        for i, j in ph.lines:
            for a2, ks in enumerate(ph.centres):
                twin.update((i, j, a2), (1, 1, len(ks)))
    return twin.result()


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("shape", [(11, 12, 13), (7, 20, 9)])
def test_schedule_emulation_is_the_twin_bitwise(shape, with_b, noise):
    rs = np.random.RandomState(17)
    x = torch.from_numpy(rs.randn(*shape))
    b = torch.from_numpy(rs.randn(*shape)) if with_b else None
    k2, h2 = 1.69, float((shape[0] - 1) ** 2)
    got = _schedule_emulation(x, b, k2, h2, 3, 5, noise)
    want = ps.fused_patch_sweep_sqfd_reference(x, b, k2, h2, 3, 5, with_noise=noise)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    # and the sweep moved the state
    assert not torch.equal(got, x)
