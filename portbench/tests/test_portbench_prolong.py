"""The fused prolong-add's roofline arithmetic: its bytes at the linear
cell's shapes and against the reference's own transfers, its operations
against the plain twin's arithmetic, and the readers of its two metrics."""

import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import harness, rooflines, rooflines_prolong, tracing
from portbench.reference import gmrf_galerkin

CELL_BYTES = [142_606_336, 17_825_792, 2_228_224, 278_528, 34_816]


def test_step_bytes_at_the_cells_shapes():
    calls = rooflines_prolong.calls(256, 128)
    assert [c[0] for c in calls] == CELL_BYTES
    assert sum(CELL_BYTES) == 162_973_696
    assert all(rooflines.bound_s(*c) == pytest.approx(c[0] / 3.35e12) for c in calls)  # bytes bound
    assert rooflines_prolong.step_bound_s(256, 128) == pytest.approx(162_973_696 / 3.35e12)
    assert rooflines_prolong.step_bound_s(256, 128) == pytest.approx(48.65e-6, rel=1e-4)


@pytest.mark.parametrize("n", [32, 64])
def test_bytes_per_call_against_the_reference_transfers(n):
    """A call reads y on a smoothed level and z on the next, and writes the
    level once: the reference's 1D prolongation (m x c) gives both grids."""
    torch.set_num_threads(1)
    ch = gmrf_galerkin.Chain(n, 1.0, 128, 2, 2, 1.0, torch.float64, "cpu")
    want = [4 * (2 * p.shape[0] ** 3 + p.shape[1] ** 3) for p in ch.P]
    assert [c[0] for c in rooflines_prolong.calls(n, 128)] == want


class _CountOps(TorchDispatchMode):
    """Elements written by the float adds and products dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in (torch.ops.aten.add, torch.ops.aten.mul):
            self.ops += out.numel()
        return out


@pytest.mark.parametrize("m", [4, 5, 8, 9, 16])
def test_ops_are_the_twins_arithmetic(m):
    from parmgmc_tpu_torch.operators.stencil import prolong

    c = (m + 1) // 2
    y, z = torch.zeros((m,) * 3), torch.ones((c,) * 3)
    with _CountOps() as count:
        y + prolong(z, y.shape)
    assert rooflines_prolong.call(m) == (4 * (2 * m**3 + c**3), count.ops)


class _Ctx:
    def __init__(self, trace, steps):
        self.trace, self.steps_traced = trace, steps
        self.config = {"n": 256, "sampler": {"coarsest_size": 128, "n_pre": 2, "n_post": 2}}


def test_metric_readers():
    us = 1_000
    tr = tracing.Trace(t0=0, t1=10_000 * us)
    tr.device = [(0, 50 * us, "(anonymous namespace)::prolong_add_kernel_vec4((anonymous namespace)::Args)"),
                 (60 * us, 80 * us, "(anonymous namespace)::prolong_add_kernel_scalar((anonymous namespace)::Args)"),
                 (100 * us, 200 * us, "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>"),
                 (300 * us, 400 * us, "residual_restrict_kernel")]
    ctx = _Ctx(tr, 2)
    roof = harness.metric_module("prolong_add_roofline").read(ctx)
    assert roof == pytest.approx(100 * 2 * rooflines_prolong.step_bound_s(256, 128) / 70e-6)
    assert math.isclose(harness.metric_module("prolong_add.ms_per_step").read(ctx), 0.035)
    for t in (None, tracing.Trace(t0=0, t1=10)):
        for name in ("prolong_add_roofline", "prolong_add.ms_per_step"):
            assert harness.metric_module(name).read(_Ctx(t, 2)) is None
