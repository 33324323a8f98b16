"""The 768^3 aggregate V(2,2) cell's drive (``drives/grid_cycle_slabs.py``),
its slab-wise reference and its two metrics on the CPU: the reference
against the program's own CPU route (``sample_chain`` on the kernels'
twins) at 24^3, in one slab and in an odd count of slabs; the drive end to
end through a configuration written in a temporary directory, its control
and three faults of the program coming out ``correct: false``; a program
off the sweep route refused at build; the sweep's bounds at 768^3 and both
readers on a hand-made trace."""

import time

import pytest
import torch

import cells
from portbench import harness, rooflines, rooflines_sweep, tracing
from portbench.reference import gmrf_cycle_slabs

# the test trees build this drive's small configuration under the name the
# repo's root conftest.py registers for it
SMALL = "gmrf3d-cycle-slabs-small-test.prior-r1"
N = 24
V22 = dict(n_pre=2, n_post=2, coarsest_size=128, coarsening="aggregate")
# float32 roundoff over two steps
ROUNDOFF = {"state_gap": 1e-5, "qoi_gap": 1e-3}


def _program_records(n, steps=2):
    """One request of ``steps`` steps of the program's CPU route from a
    chain 3 steps in: [(start field, start key, end field, QOI)]."""
    from parmgmc_tpu_torch.chain import init_chain, sample_chain
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    smp = MGMCSampler.create(gmrf_3d(n, 1.0, dtype=torch.float32, device="cpu"), **V22)
    st, _ = sample_chain(smp, init_chain(smp, 2**33 + n), None, 3, extract=torch.mean)
    end, q = sample_chain(smp, st, None, steps, extract=torch.mean)
    return [(st.x, st.key, end.x, q)]


class _Drive:
    """What ``harness.judge`` reads of a drive: its steps and reference."""

    def __init__(self, n, steps=2, slab=None):
        self.steps, self.n, self.slab = steps, n, slab

    def reference(self, dtype, device, store=None):
        return gmrf_cycle_slabs.Chain(self.n, 1.0, 128, 2, 2, 1.0, dtype, device, store=store,
                                      slab=self.slab)


@pytest.mark.parametrize("slab", [None, 7], ids=["one-slab", "odd-slab-count"])
def test_reference_follows_the_program(slab):
    torch.set_num_threads(1)
    drive = _Drive(N, slab=slab)
    ch = drive.reference(torch.float64, "cpu")
    lev = ch.levels[0]
    # 7, 7, 7 and 3 planes; the residual's even slabs 8, 8, 8
    assert (len(lev.slabs()), len(lev.slabs(even=True))) == ((1, 1) if slab is None else (4, 3))
    numbers = harness.judge(drive, _program_records(N))
    assert all(numbers[k] <= ROUNDOFF[k] for k in ROUNDOFF), numbers


@pytest.mark.parametrize("dtype, store", [(torch.float64, None), (torch.float32, torch.bfloat16)],
                         ids=["float64", "bf16-storage"])
def test_slab_count_invariance(dtype, store):
    torch.set_num_threads(1)
    x0 = torch.randn((N,) * 3, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    one = gmrf_cycle_slabs.Chain(N, 1.0, 128, 2, 2, 1.0, dtype, "cpu", store=store)
    thin = gmrf_cycle_slabs.Chain(N, 1.0, 128, 2, 2, 1.0, dtype, "cpu", store=store, slab=3)
    assert len(one.levels[0].slabs()) == 1 and len(thin.levels[0].slabs()) == 8
    before = x0.clone()
    x1, q1 = one.follow(2**41 + 3, x0, 2)
    x3, q3 = thin.follow(2**41 + 3, x0, 2)
    assert torch.equal(x0, before)  # the start is left as it was
    rel = lambda a, b: float((a.double() - b.double()).abs().max() / b.double().abs().max())
    assert rel(x3, x1) <= 1e-12 and rel(q3, q1) <= 1e-12
    for lev in thin.levels:
        held = [t for t in vars(lev).values() if isinstance(t, torch.Tensor)]
        assert held and all(t.numel() < lev.n**3 for t in held)


def test_reference_refuses_odd_extents():
    with pytest.raises(ValueError):
        gmrf_cycle_slabs.Chain(25, 1.0, 128, 2, 2, 1.0, torch.float64, "cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cells.tree(str(tmp_path_factory.mktemp("bench")), N, 1)


def _run(root, **kw):
    torch.set_num_threads(1)
    return harness.run(root, SMALL, 2**31 + 43, 0.2, False, "cpu", time.perf_counter(), **kw)


def test_sound_run_passes(root):
    assert SMALL in cells.cells_of(root, "grid_cycle_slabs")
    out = _run(root)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert {"sample_ms", "indep_sample_ms", "request_ms_p95", "setup_s"} == set(out["metrics"])
    # on the CPU every call of the general cycle is plain torch: the fine
    # residual and one a smoothed level (24^3, 12^3), a prolong-add a level
    steps = out["route"]["steps"]
    assert out["route"]["launches"] == {"residual_torch": 3 * steps, "prolong_add_torch": 2 * steps}


def test_control_fails(root):
    out = _run(root, control=(torch.float32, torch.bfloat16))
    assert not out["correct"]
    assert out["checks"]["state_gap"]["value"] > 3 * out["checks"]["state_gap"]["limit"]


def _skip_last_post_sweep(monkeypatch):
    """Level 0's last post-sweep of every step returns its input (its
    draws still read off the step's words)."""
    from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler

    real, calls = GibbsSampler.step_from, [0]

    def step_from(self, cur, x, b):
        if tuple(x.shape) != (N,) * 3:
            return real(self, cur, x, b)
        calls[0] += 1
        if calls[0] % 4:
            return real(self, cur, x, b)
        for _ in self._dirs():
            cur.launch()
        return x

    monkeypatch.setattr(GibbsSampler, "step_from", step_from)


def _unrestricted_residual(monkeypatch):
    """Level 1's residual read at the coarse points instead of summed over
    their blocks."""
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    real = MGMCSampler._residual

    def residual(self, l, x, b, restrict=True):
        if l != 1 or not restrict:
            return real(self, l, x, b, restrict)
        return real(self, l, x, b, restrict=False)[::2, ::2, ::2].contiguous()

    monkeypatch.setattr(MGMCSampler, "_residual", residual)


def _wrong_noise_domain(monkeypatch):
    """Every sweep's draws hashed under the 27-point sweep's domain."""
    from parmgmc_tpu_torch.kernels import _noise

    monkeypatch.setattr(_noise, "SWEEP_DOMAIN", _noise.GALERKIN_DOMAIN)


@pytest.mark.parametrize("fault", [_skip_last_post_sweep, _unrestricted_residual, _wrong_noise_domain],
                         ids=["skipped-post-sweep", "unrestricted-residual", "wrong-noise-domain"])
def test_faults_fail(root, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(root)
    assert not out["correct"], out["checks"]


def test_program_off_the_route_is_refused_at_build(root, monkeypatch):
    """A program whose smoothed levels sweep on another route (the plain
    one) fails at build, before any window."""
    from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler

    monkeypatch.setattr(GibbsSampler, "route", property(lambda self: "torch"))
    with pytest.raises(RuntimeError, match="fused_rb_gibbs_sweep_fd"):
        _run(root)


def test_sweep_bounds_at_768():
    nbytes, ops = rooflines_sweep.call(768)
    assert nbytes == 5_435_817_984 and rooflines.bound_s(nbytes, ops) == pytest.approx(1.6226e-3, rel=1e-4)
    assert rooflines.bound_s(nbytes, ops) == pytest.approx(nbytes / rooflines.PEAK_BYTES_PER_S)  # bytes
    below = rooflines_sweep.step(rooflines.levels(768, 128)[1:], 4)
    assert len(below) == 24 and sum(c[0] for c in below) == 3_106_169_856
    assert sum(rooflines.bound_s(*c) for c in below) == pytest.approx(0.927e-3, rel=1e-3)
    assert rooflines_sweep.step_bound_s(768, 128, 4) == pytest.approx(7.418e-3, rel=1e-4)


MS = 1_000_000
SWEEP = "void (anonymous namespace)::sweep_march_kernel<false, true>(float const*, float const*)"


class _Ctx:
    def __init__(self, trace, steps):
        self.trace, self.steps_traced = trace, steps
        self.config = {"n": 768, "sampler": {"coarsest_size": 128, "n_pre": 2, "n_post": 2}}


def _trace():
    """Two steps: 28 sweeps of 0.5 ms, a plain-torch add of 3 ms, a copy
    of 1 ms and a chain kernel of 2 ms a step."""
    tr = tracing.Trace(t0=0, t1=100 * MS)
    for s in range(2):
        t = 50 * MS * s
        tr.device += [(t + i * MS, t + i * MS + MS // 2, SWEEP) for i in range(28)]
        tr.device.append((t + 30 * MS, t + 33 * MS, "void at::native::elementwise_kernel<128, 2>(...)"))
        tr.device.append((t + 34 * MS, t + 35 * MS, "Memcpy DtoD (Device -> Device)"))
        tr.device.append((t + 36 * MS, t + 38 * MS, "void chain_march_kernel<true, true>(x)"))
    return tr


def test_metric_readers():
    ctx = _Ctx(_trace(), 2)
    roof = harness.metric_module("sweep_march_roofline").read(ctx)
    assert roof == pytest.approx(100 * 2 * rooflines_sweep.step_bound_s(768, 128, 4) / (56 * 0.5e-3))
    assert harness.metric_module("plain_torch.ms_per_step").read(ctx) == pytest.approx(4.0)


@pytest.mark.parametrize("name", ["sweep_march_roofline", "plain_torch.ms_per_step"])
def test_readers_find_nothing_return_nothing(name):
    mod = harness.metric_module(name)
    assert mod.read(_Ctx(None, 2)) is None
    assert mod.read(_Ctx(tracing.Trace(t0=0, t1=10 * MS), 2)) is None
    assert mod.read(_Ctx(_trace(), 0)) is None
    if name == "sweep_march_roofline":  # a trace without the sweep
        other = tracing.Trace(t0=0, t1=10 * MS, device=[(0, MS, "void tail_grid_kernel<true>(x)")])
        assert mod.read(_Ctx(other, 2)) is None
