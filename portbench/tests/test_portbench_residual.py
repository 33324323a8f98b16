"""The fused residual's roofline arithmetic against the reference's own
operators, and the readers of its two metrics."""

import pytest
import torch

from portbench import harness, rooflines, rooflines_residual, tracing
from portbench.reference import gmrf_galerkin


def _grid_fields(lv):
    """Coefficient fields of a reference level that are not one value
    wherever their neighbour exists: what the program keeps as fields."""
    n = lv.shape[0]
    count = 0
    for o, c in lv.coef.items():
        region = c[tuple(slice(max(0, -a), n - max(0, a)) for a in o)]
        count += bool(region.max() != region.min())
    return count


@pytest.mark.parametrize("n", [32, 64])
def test_bytes_per_call_against_the_reference_levels(n):
    """Each call of a step reads x and b (the fine residual of the prior: x
    alone), D where it is not link-count FD and every grid-shaped field,
    and writes its output once."""
    torch.set_num_threads(1)
    ch = gmrf_galerkin.Chain(n, 1.0, 128, 2, 2, 1.0, torch.float64, "cpu")
    smoothed = ch.levels[:-1]
    assert isinstance(smoothed[0], gmrf_galerkin.FD) and len(smoothed) >= 2
    want = [4 * 2 * n**3]
    for lv in smoothed:
        pts = lv.D.numel()
        fd = isinstance(lv, gmrf_galerkin.FD)
        streams = 2 + (0 if fd else 1 + _grid_fields(lv))
        want.append(4 * (streams * pts + ((lv.shape[0] + 1) // 2) ** 3))
    got = rooflines_residual.calls(n, 128)
    assert [c[0] for c in got] == want
    assert all(rooflines.bound_s(*c) == pytest.approx(c[0] / 3.35e12) for c in got)  # bytes bound


def test_step_bound_at_the_cells_shapes():
    calls = rooflines_residual.calls(256, 128)
    assert [c[0] for c in calls] == [134_217_728, 142_606_336, 177_209_344, 22_151_168, 2_768_896, 346_112]
    assert rooflines_residual.step_bound_s(256, 128) == pytest.approx(479_299_584 / 3.35e12)


class _Ctx:
    def __init__(self, trace, steps):
        self.trace, self.steps_traced = trace, steps
        self.config = {"n": 256, "sampler": {"coarsest_size": 128, "n_pre": 2, "n_post": 2}}


def test_metric_readers():
    ms = 1_000_000
    tr = tracing.Trace(t0=0, t1=10 * ms)
    tr.device = [(0, ms, "void (anonymous namespace)::residual_restrict_kernel<true>(...)"),
                 (ms, 2 * ms, "void (anonymous namespace)::residual_restrict_kernel<false>(...)"),
                 (3 * ms, 4 * ms, "galerkin_sweep_kernel")]
    ctx = _Ctx(tr, 4)
    roof = harness.metric_module("residual_restrict_roofline").read(ctx)
    assert roof == pytest.approx(100 * 4 * rooflines_residual.step_bound_s(256, 128) / 2e-3)
    assert harness.metric_module("residual_restrict.ms_per_step").read(ctx) == pytest.approx(0.5)
    for t in (None, tracing.Trace(t0=0, t1=10)):
        for name in ("residual_restrict_roofline", "residual_restrict.ms_per_step"):
            assert harness.metric_module(name).read(_Ctx(t, 4)) is None
