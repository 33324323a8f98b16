"""The linear-Galerkin cell's drive and reference on the CPU: the drive
end to end at 16^3 through a configuration written in a temporary
directory, its control and two faults coming out ``correct: false``; the
reference's Galerkin levels against the frozen field count of the
roofline; a program built without the 27-point kernel refused at build."""

import json
import os
import shutil
import time

import pytest
import torch

from portbench import harness, rooflines, rooflines_galerkin
from portbench.reference import gmrf_galerkin

ROOT = os.path.dirname(harness.PKG)
CELL = "gmrf256-v22-linear"
SMALL = "gmrf3d-cycle-small-test.prior-r16"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tree holding the repo's manifest with the cell's configuration at
    16^3 and coarsest size 64: levels 16^3, 8^3 (27-point) and 4^3."""
    tmp = str(tmp_path_factory.mktemp("bench"))
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for d in ("traffic", "workloads"):
        shutil.copytree(os.path.join(harness.PKG, d), os.path.join(tmp, "portbench", d))
    os.makedirs(os.path.join(tmp, "portbench", "configs"))
    entry = next(w for w in man["workloads"] if w["name"] == CELL)
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    body = json.load(open(os.path.join(ROOT, conf["file"])))
    body.update(name="gmrf3d-cycle-small-test", n=16, levels=[16, 8, 4])
    body["sampler"] = dict(body["sampler"], coarsest_size=64)
    path = "portbench/configs/gmrf3d-cycle-small-test.json"
    json.dump(body, open(os.path.join(tmp, path), "w"))
    man["configs"] = [dict(conf, name=body["name"], file=path)]
    man["workloads"] = [dict(entry, name=SMALL, config=body["name"])]
    shutil.copy(os.path.join(harness.PKG, "workloads", f"{CELL}.json"),
                os.path.join(tmp, "portbench", "workloads", f"{SMALL}.json"))
    json.dump(man, open(os.path.join(tmp, "BENCHMARK.json"), "w"))
    return tmp


def _run(root, **kw):
    torch.set_num_threads(1)
    return harness.run(root, SMALL, 2**31 + 29, 0.2, False, "cpu", time.perf_counter(), **kw)


def test_sound_run_passes(root):
    out = _run(root)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["route"]["steps"] % 16 == 0
    assert {"sample_ms", "indep_sample_ms", "request_ms_p95", "setup_s"} == set(out["metrics"])


def test_control_fails(root):
    out = _run(root, control=(torch.float32, torch.bfloat16))
    assert not out["correct"]
    assert out["checks"]["state_gap"]["value"] > 3 * out["checks"]["state_gap"]["limit"]


def test_step_that_returns_its_state_fails(root, monkeypatch):
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    real = MGMCSampler.step
    monkeypatch.setattr(MGMCSampler, "step", lambda self, key, x, b, aux=None: (
        real(self, key, x, b, aux)[0], x))
    assert not _run(root)["correct"]


def test_sample_nudged_where_produced_fails(root, monkeypatch):
    """The step's sample nudged by 1 %."""
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    real = MGMCSampler.step
    monkeypatch.setattr(MGMCSampler, "step", lambda self, *a, **k: (
        (lambda r: (r[0], r[1] * 1.01))(real(self, *a, **k))))
    assert not _run(root)["correct"]


def test_program_without_the_kernel_is_refused_at_build(root, monkeypatch):
    """A program whose 27-point levels sweep on another route (the plain
    one) fails at build, before any window."""
    from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler

    monkeypatch.setattr(GibbsSampler, "route", property(lambda self: "torch"))
    with pytest.raises(RuntimeError, match="fused_galerkin_sweep"):
        _run(root)


def test_roofline_field_count_at_32():
    """The reference's own Galerkin levels of a 32^3 grid hold
    ``rooflines_galerkin.FIELDS`` grid-shaped fields each: offsets whose
    coefficient is not one value wherever the neighbour exists."""
    ch = gmrf_galerkin.Chain(32, 1.0, 128, 2, 2, 1.0, torch.float64, "cpu")
    smoothed = [lv for lv in ch.levels[1:] if lv is not None]
    assert [lv.shape for lv in smoothed] == [(16, 16, 16)]
    ops = [gmrf_galerkin.galerkin(smoothed[0], gmrf_galerkin.prolongation_1d(16, torch.float64, "cpu"),
                                  8)]
    for lv in smoothed + ops:
        n = lv.shape[0]
        fields = 0
        for o, c in lv.coef.items():
            region = c[tuple(slice(max(0, -a), n - max(0, a)) for a in o)]
            fields += bool(region.max() != region.min())
        assert len(lv.coef) == 26 and fields == rooflines_galerkin.FIELDS


def test_roofline_arithmetic():
    assert rooflines_galerkin.extents(256, 128) == [256, 128, 64, 32, 16, 8]
    nbytes, ops = rooflines_galerkin.half_sweep(128)
    assert nbytes == 4 * 128**3 * 22 == 184_549_376
    assert ops == 128**3 * 85
    assert rooflines.bound_s(nbytes, ops) == pytest.approx(nbytes / 3.35e12)  # bandwidth-bound
    want = 4 * sum(4 * m**3 * 22 for m in (128, 64, 32, 16)) / 3.35e12
    assert rooflines_galerkin.step_bound_s(256, 128, 4) == pytest.approx(want)


class _Ctx:
    def __init__(self, trace, steps):
        self.trace, self.steps_traced = trace, steps
        self.config = {"n": 256, "sampler": {"coarsest_size": 128, "n_pre": 2, "n_post": 2}}


def test_metric_readers():
    from portbench import tracing

    ms = 1_000_000
    tr = tracing.Trace(t0=0, t1=10 * ms)
    tr.device = [(0, 2 * ms, "void (anonymous namespace)::galerkin_sweep_kernel<false>(...)"),
                 (3 * ms, 4 * ms, "elementwise")]
    ctx = _Ctx(tr, 4)
    roof = harness.metric_module("galerkin_sweep_roofline").read(ctx)
    assert roof == pytest.approx(100 * 4 * rooflines_galerkin.step_bound_s(256, 128, 4) / 2e-3)
    assert harness.metric_module("galerkin_sweep.ms_per_step").read(ctx) == pytest.approx(0.5)
    for t in (None, tracing.Trace(t0=0, t1=10)):
        for name in ("galerkin_sweep_roofline", "galerkin_sweep.ms_per_step"):
            assert harness.metric_module(name).read(_Ctx(t, 4)) is None
