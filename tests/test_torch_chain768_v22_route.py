"""The 768^3 aggregate V(2,2) prior's route in miniature, at 48^3, the
slab-wise reference that judges it (``portbench/reference/
gmrf_cycle_slabs.py``) and the counters of the general cycle's plain-torch
calls.

With ``rb_gibbs._PLANE_LIMIT`` patched between 24^2 and 48^2 points, 48^3
takes 768^3's route: levels 48, 24, 12 and a 6^3 dense Cholesky level;
level 0's sweeps on the staged large-plane sweep (#9), 24^3's and 12^3's
on the whole-plane sweep (#7).  On the CPU the kernels' twins run.

* A step sweeps four times a smoothed level, in the cycle's order, and
  counts the fine residual and one residual a smoothed level as
  ``residual_torch``, one prolong-add a smoothed level as
  ``prolong_add_torch``.
* Three 2-step requests of ``sample_chain`` from a seeded state against
  the slab-wise reference in float64 (the benchmark's judge), worked in
  slabs of 5 planes: within float32 roundoff; the bfloat16-storage
  control, run in the program's place, fails the same limits.
* One eager step at 24^3 counts both plain-torch counters as its
  hierarchy's smoothed levels say, on the aggregate hierarchy and on the
  linear one (no residual or prolong-add kernel on the CPU).
"""

import os
import sys
import types

import pytest
import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.chain import init_chain, sample_chain
from parmgmc_tpu_torch.kernels import rb_gibbs
from parmgmc_tpu_torch.models.problems import gmrf_3d
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402
from portbench.reference import gmrf_cycle_slabs  # noqa: E402

DEV = "cpu"
N = 48
V22 = dict(n_pre=2, n_post=2, coarsest_size=128, coarsening="aggregate")
STEPS, REQUESTS = 2, 3
# float32 roundoff over 6 steps; the bf16-storage control reads above 1e-2
# and 0.1 (portbench/tests/test_portbench_cycle_slabs.py, PERF.md section 2)
LIMITS = {"state_gap": 1e-4, "qoi_gap": 1e-3}
SWEEPS = ("fused_rb_gibbs_sweep_2d_staged", "fused_rb_gibbs_sweep_fd_reference")


@pytest.fixture
def route(monkeypatch):
    """768^3's route at 48^3: a large-plane limit between 24^2 and 48^2
    points and a spy on the two sweeps' entries (#9's wrapper, #7's twin);
    returns the list their calls go to."""
    monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 1024)
    calls = []
    for name in SWEEPS:
        def spy(*a, _fn=getattr(rb_gibbs, name), _name=name, **kw):
            calls.append((_name, a[0].shape[0]))
            return _fn(*a, **kw)

        monkeypatch.setattr(rb_gibbs, name, spy)
    return calls


# what ``harness.judge`` reads of a drive: its reference and steps
DRIVE = types.SimpleNamespace(
    steps=STEPS,
    reference=lambda dtype, dev, store=None: gmrf_cycle_slabs.Chain(
        N, 1.0, 128, 2, 2, 1.0, dtype, dev, store=store, slab=5))


def _sampler(n=N, **kw):
    return MGMCSampler.create(gmrf_3d(n, 1.0, dtype=torch.float32, device=DEV), **{**V22, **kw})


def test_route_is_768s(route):
    smp = _sampler()
    assert [op.grid_shape[0] for op in smp.ops] == [48, 24, 12, 6]
    assert not smp.deferred_eligible()
    kernels.reset_launch_counts()
    sample_chain(smp, init_chain(smp, 3), None, 2, extract=torch.mean)
    staged, twin = SWEEPS
    cycle = [(staged, 48)] * 2 + [(twin, 24)] * 2 + [(twin, 12)] * 4 + [(twin, 24)] * 2 + [(staged, 48)] * 2
    assert route == cycle * 2
    assert kernels.launch_counts() == dict(dict.fromkeys(kernels.launch_counts(), 0),
                                           residual_torch=4 * 2, prolong_add_torch=3 * 2)


def test_requests_follow_the_cycle_slab_reference(route):
    torch.set_num_threads(1)
    smp = _sampler()
    g = torch.Generator().manual_seed(48)
    state = init_chain(smp, 2**33 + 9, x0=torch.randn((N,) * 3, generator=g))
    records = []
    for _ in range(REQUESTS):
        start = state
        state, q = sample_chain(smp, start, None, STEPS, extract=torch.mean)
        records.append((start.x, start.key, state.x, q))
    assert len(route) == 12 * STEPS * REQUESTS
    numbers = harness.judge(DRIVE, records)
    assert all(numbers[k] <= LIMITS[k] for k in LIMITS), numbers
    control = DRIVE.reference(torch.float32, DEV, store=torch.bfloat16)
    numbers = harness.judge(DRIVE, records, program=control)
    assert not all(numbers[k] <= LIMITS[k] for k in LIMITS), numbers


@pytest.mark.parametrize("coarsening", ["aggregate", "linear"])
def test_one_step_counts_its_plain_torch_calls(coarsening):
    smp = _sampler(24, coarsening=coarsening)
    smoothed = smp.n_levels - 1
    assert smoothed == 2
    kernels.reset_launch_counts()
    key, x = smp.step(5, torch.zeros(smp.grid_shape), None)
    counts = kernels.launch_counts()
    assert counts == dict(dict.fromkeys(counts, 0), residual_torch=1 + smoothed,
                          prolong_add_torch=smoothed), counts
    assert kernels.launch_counts(plain=False) == dict.fromkeys(kernels.launch_counts(plain=False), 0)
    assert set(kernels.launch_counts()) - set(kernels.launch_counts(plain=False)) == set(kernels.PLAIN)
    assert key != 5 and bool(torch.isfinite(x).all())
