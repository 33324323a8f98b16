"""The benchmark's frozen arithmetic on known inputs."""

import numpy as np
import pytest

from portbench import harness, rooflines, stats, tracing


def test_sample_ms():
    assert stats.sample_ms(3.0, 1000, 2) == pytest.approx(1.5)


@pytest.mark.parametrize("tau, want", [(0.5, 2.0), (1.0, 2.0), (2.5, 5.0)])
def test_indep_sample_clamps_tau_at_one(tau, want):
    assert stats.indep_sample_ms(2.0, tau) == pytest.approx(want)


def test_p95_over_all_requests():
    assert stats.percentile(np.arange(1, 101), 95) == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0
    # one slow request among 100 moves the 99th, not the median
    v = [10.0] * 99 + [1000.0]
    assert stats.percentile(v, 50) == 10.0 and stats.percentile(v, 99.5) > 10.0


def _ar1(phi, n, seed):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal(n)
    x = np.empty(n)
    x[0] = e[0] / np.sqrt(1 - phi * phi)
    for i in range(1, n):
        x[i] = phi * x[i - 1] + e[i]
    return x


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.8])
def test_frozen_tau_on_ar1(phi):
    """tau of AR(1) is (1 + phi) / (1 - phi); the frozen estimate equals
    the program's own on the same series."""
    from parmgmc_tpu_torch.diagnostics.iact import iact

    x = _ar1(phi, 100_000, 1234)
    want = (1 + phi) / (1 - phi)
    got = stats.iact(x)
    assert got == pytest.approx(want, rel=0.08)
    assert got == pytest.approx(iact(x)[0], rel=1e-9)
    assert stats.mean_tau(np.stack([x, x])) == pytest.approx(got)


def test_roofline_bytes_at_the_cells_shapes():
    b, ops = rooflines.chain_down_fd(256, with_b=False, with_z=True)
    assert b == 4 * (2 * 256**3 + 2 * 128**3) == 150_994_944
    assert rooflines.chain_down_fd(256, with_b=True, with_z=True)[0] == 4 * (3 * 256**3 + 2 * 128**3)
    assert rooflines.bound_s(b, ops) == pytest.approx(b / 3.35e12)  # bandwidth-bound
    assert rooflines.levels(256, 128) == [256, 128, 64, 32, 16, 8]
    tb, tops = rooflines.tail_down([128, 64, 32, 16, 8])
    assert tb == 4 * (128**3 + (128**3 + 64**3 + 32**3 + 16**3) + 8**3) == 17_975_296
    assert rooflines.bound_s(tb, tops) == pytest.approx(tb / 3.35e12)


def _trace():
    ms = 1_000_000
    tr = tracing.Trace(t0=0, t1=10 * ms)
    tr.device = [(1 * ms, 3 * ms, "void chain_march_kernel<true, true>(...)"),
                 (2 * ms, 4 * ms, "elementwise"), (6 * ms, 7 * ms, "void tail_grid_kernel<true>(x)")]
    tr.host_ops = [(0, 1 * ms, "aten::add"), (4 * ms, 6 * ms, "aten::matmul")]
    return tr


def test_trace_reduction():
    tr = _trace()
    assert tr.busy_s == pytest.approx(4e-3) and tr.window_s == pytest.approx(1e-2)
    assert tr.kernel_time(("chain_march_kernel",)) == (1, pytest.approx(2e-3))
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::add"] == pytest.approx(1e-3) and gaps["aten::matmul"] == pytest.approx(2e-3)
    assert gaps["host (between torch ops)"] == pytest.approx(3e-3)
    assert tr.device_ops()[0][1] == pytest.approx(2e-3)


class _Ctx:
    def __init__(self, trace, steps, n=256, traffic=None):
        self.trace, self.steps_traced = trace, steps
        self.config = {"n": n, "sampler": {"coarsest_size": 128}}
        self.traffic = traffic or {"observations": None}
        self.qoi = np.stack([_ar1(0.5, 20_000, 7)])


def test_metric_readers():
    ctx = _Ctx(_trace(), 2)
    read = lambda name: harness.metric_module(name).read(ctx)
    assert read("device.idle_pct") == pytest.approx(60.0)
    assert read("device.busy_ms_per_step") == pytest.approx(2.0)
    assert read("sampler.device_ops_per_step") == pytest.approx(1.5)
    assert read("chain.host_ops_per_step") == pytest.approx(1.0)
    assert read("sampler.tau") == pytest.approx(3.0, rel=0.1)
    b, _ = rooflines.chain_down_fd(256, False, True)
    assert read("chain_down_fd_roofline") == pytest.approx(100 * b / 3.35e12 / 2e-3)
    tb, _ = rooflines.tail_down([128, 64, 32, 16, 8])
    assert read("tail_down_roofline") == pytest.approx(100 * tb / 3.35e12 / 1e-3)


def test_readers_find_nothing_return_nothing():
    empty = tracing.Trace(t0=0, t1=10)
    for name in ("device.idle_pct", "device.busy_ms_per_step", "sampler.device_ops_per_step",
                 "chain.host_ops_per_step", "chain_down_fd_roofline", "tail_down_roofline"):
        assert harness.metric_module(name).read(_Ctx(empty, 4)) is None
        assert harness.metric_module(name).read(_Ctx(None, 4)) is None


def test_profiler_reduction_on_the_host():
    import torch

    x = torch.randn(1000)
    with tracing.session("cpu") as prof:
        for _ in range(3):
            with torch.profiler.record_function(tracing.REQUEST):
                (x * 2 + 1).sum()
    tr = tracing.reduce(prof)
    names = [n for _, _, n in tr.host_ops]
    assert names.count("aten::mul") == 3 and names.count("aten::sum") == 3
    assert not tr.device and tr.window_s > 0
