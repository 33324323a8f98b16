"""The 768^3 prior cell's drive (``drives/grid_slabs.py``), its slab-wise
reference and its two kernel metrics on the CPU: the cell end to end at
24^3 (level 1 keyed alone, as every level below 768^3's level 0 is) and
32^3 (level 1 on the tail) through a configuration written in a temporary
directory, its control coming out ``correct: false``; both readers on a
synthetic trace holding #5's and #3's launches; both bounds at 768^3."""

import time

import pytest
import torch

import cells
from portbench import harness, rooflines, rooflines_march, tracing

# the test trees build this drive's small configuration under the name the
# repo's root conftest.py registers for it
SMALL = "gmrf3d-slabs-small-test.prior-r16"


@pytest.fixture(scope="module", params=[24, 32])
def root(request, tmp_path_factory):
    return cells.tree(str(tmp_path_factory.mktemp("bench")), request.param, 1)


def _run(root, **kw):
    torch.set_num_threads(1)
    return harness.run(root, SMALL, 2**31 + 41, 0.2, False, "cpu", time.perf_counter(), **kw)


def test_cell_runs_on_the_host(root):
    assert SMALL in cells.cells_of(root, "grid_slabs")
    out = _run(root)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["route"]["steps"] % 16 == 0
    assert {"sample_ms", "indep_sample_ms", "request_ms_p95", "setup_s"} == set(out["metrics"])


def test_control_fails(root):
    out = _run(root, control=(torch.float32, torch.bfloat16))
    assert not out["correct"]
    assert out["checks"]["state_gap"]["value"] > 3 * out["checks"]["state_gap"]["limit"]


def test_reference_refuses_observations():
    from portbench.reference import gmrf_slabs

    with pytest.raises(ValueError):
        gmrf_slabs.Chain(8, 1.0, 8, torch.float64, "cpu", obs={"values": [0.0]})


MS = 1_000_000
NAME5 = "void (anonymous namespace)::chain_march_kernel<true, true>(float const*, float const*)"
NAME3 = "void (anonymous namespace)::chain_march_kernel<false, true>(float const*, float const*)"


class _Ctx:
    def __init__(self, trace, steps):
        self.trace, self.steps_traced = trace, steps
        self.config = {"n": 768, "sampler": {"coarsest_size": 128}}
        self.traffic = {"observations": None}


def _trace():
    """Two steps: #5 takes 5 ms a call, #3 six calls of 0.2 ms a step."""
    tr = tracing.Trace(t0=0, t1=40 * MS)
    for s in range(2):
        t = 20 * MS * s
        tr.device.append((t, t + 5 * MS, NAME5))
        tr.device += [(t + 6 * MS + i * MS, t + 6 * MS + i * MS + MS // 5, NAME3) for i in range(6)]
    tr.device.append((39 * MS, 39 * MS + MS // 2, "void tail_grid_kernel<true>(x)"))
    return tr


def test_readers_tell_the_modes_apart():
    ctx = _Ctx(_trace(), 2)
    read = lambda name: harness.metric_module(name).read(ctx)
    b, ops = rooflines.chain_down_fd(768, with_b=False, with_z=True)
    assert read("chain_down_2d_roofline") == pytest.approx(100 * rooflines.bound_s(b, ops) / 5e-3)
    bound = rooflines.bound_s(*rooflines_march.zero_restrict(rooflines.levels(768, 128)[1:]))
    assert read("zero_restrict_roofline") == pytest.approx(100 * bound * 2 / (12 * 2e-4))
    # the same trace read as #1's share would book all seven launches a step
    assert harness.metric_module("chain_down_fd_roofline").read(ctx) == pytest.approx(
        100 * 14 * rooflines.bound_s(b, ops) / (2 * 5e-3 + 12 * 2e-4))


def test_readers_find_nothing_return_nothing():
    other = tracing.Trace(t0=0, t1=10 * MS, device=[(0, MS, "void tail_grid_kernel<true>(x)")])
    for name in ("chain_down_2d_roofline", "zero_restrict_roofline"):
        mod = harness.metric_module(name)
        assert mod.read(_Ctx(None, 2)) is None and mod.read(_Ctx(other, 2)) is None
    assert harness.metric_module("zero_restrict_roofline").read(_Ctx(_trace(), 0)) is None


def test_bounds_at_768():
    ext = rooflines.levels(768, 128)
    assert ext == [768, 384, 192, 96, 48, 24, 12, 6]
    b, ops = rooflines.chain_down_fd(768, with_b=False, with_z=True)
    assert b == 4_076_863_488 and rooflines.bound_s(b, ops) == pytest.approx(1.2170e-3, rel=1e-4)
    zb, zops = rooflines_march.zero_restrict(ext[1:])
    assert zb == 550_050_912 and zops == 3_753_288_576
    assert rooflines.bound_s(zb, zops) == pytest.approx(zb / rooflines.PEAK_BYTES_PER_S)  # bytes
    assert rooflines.bound_s(zb, zops) == pytest.approx(0.1642e-3, rel=1e-3)
