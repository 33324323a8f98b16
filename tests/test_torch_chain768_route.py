"""The 768^3 aggregate V(1,0) prior's route in miniature, at 48^3, and the
slab-wise reference that judges it (``portbench/reference/gmrf_slabs.py``).

With ``rb_gibbs._PLANE_LIMIT`` patched small, 48^3 takes 768^3's route:
levels 48, 24, 12 and a 6^3 dense Cholesky level; level 0 on the staged
large-plane chain kernel (#5), 24^3 and 12^3 each on the from-zero
down-phase kernel (#3), which the tail's shape rule refuses, and no tail
call.  On the CPU the kernels' twins run.

* A step calls exactly one ``fused_chain_down_2d_staged``, two
  ``fused_zero_gibbs_restrict_fd`` and no ``fused_tail_down``.
* Three 4-step requests of ``sample_chain_deferred`` from a seeded state
  against the slab-wise reference in float64 (the benchmark's judge):
  within float32 roundoff over 12 steps, two decades below what the
  bfloat16-storage control reads at 256^3; the control itself, run in the
  program's place, fails the same limits.
* The slab-wise reference is ``gmrf.Chain`` with slabs of 5 planes (the
  last one ragged) at 24^3 and 48^3, in float64 and in the control's
  float32 with bfloat16 storage, and no level holds a grid-sized tensor.
* On the card (marker ``cuda``): the same requests, replayed, count one
  ``chain_2d_staged`` and two ``zero_restrict`` launches a step.
"""

import os
import sys
import types

import pytest
import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.chain import init_chain, sample_chain_deferred
from parmgmc_tpu_torch.kernels import mg_sweep, mg_tail, rb_gibbs
from parmgmc_tpu_torch.models.problems import gmrf_3d
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402
from portbench.reference import gmrf, gmrf_slabs  # noqa: E402

DEV = "cpu"
N = 48
V10 = dict(n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate")
STEPS, REQUESTS = 4, 3
# float32 roundoff over 12 steps; the bf16-storage control reads 3.2e-2 and
# 0.84 at 256^3 (PERF.md section 2)
LIMITS = {"state_gap": 1e-4, "qoi_gap": 1e-3}
WRAPPERS = ((mg_sweep, "fused_chain_down_fd"), (mg_sweep, "fused_chain_down_2d"),
            (mg_sweep, "fused_chain_down_2d_staged"), (mg_sweep, "fused_zero_gibbs_restrict_fd"),
            (mg_tail, "fused_tail_down"))


@pytest.fixture
def route(monkeypatch):
    """768^3's route at 48^3: a large-plane limit below 48^2 points and a
    spy on every chain-kernel wrapper; returns the list its calls go to."""
    monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 64)
    calls = []
    for module, name in WRAPPERS:
        def spy(*a, _fn=getattr(module, name), _name=name, **kw):
            calls.append((_name, tuple(a[0].shape)))
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, spy)
    return calls


# what ``harness.judge`` reads of a drive: its reference and steps
DRIVE = types.SimpleNamespace(
    steps=STEPS,
    reference=lambda dtype, dev, store=None: gmrf_slabs.Chain(N, 1.0, 128, dtype, dev, store=store))


def _requests(device):
    """REQUESTS consecutive requests of STEPS steps from a seeded state:
    [(start field, start key, end field, QOI)]."""
    smp = MGMCSampler.create(gmrf_3d(N, 1.0, dtype=torch.float32, device=device), **V10)
    g = torch.Generator().manual_seed(24)
    state = init_chain(smp, 2**33 + 5, x0=torch.randn((N,) * 3, generator=g).to(device))
    records = []
    for _ in range(REQUESTS):
        start = state
        state, q = sample_chain_deferred(smp, start, None, STEPS)
        records.append((start.x, start.key, state.x, q.cpu()))
    return records


def _within(numbers):
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def test_route_is_768s(route):
    smp = MGMCSampler.create(gmrf_3d(N, 1.0, dtype=torch.float32, device=DEV), **V10)
    assert [op.grid_shape[0] for op in smp.ops] == [48, 24, 12, 6]
    assert smp._chain_level0_2d() and smp.deferred_eligible()
    assert not any(smp._tail_fused_eligible(l) for l in range(1, smp.n_levels - 1))
    sample_chain_deferred(smp, init_chain(smp, 3), None, 2)
    step = [("fused_chain_down_2d_staged", (48, 48, 48)), ("fused_zero_gibbs_restrict_fd", (24, 24, 24)),
            ("fused_zero_gibbs_restrict_fd", (12, 12, 12))]
    assert route == step * 2


def test_requests_follow_the_slab_reference(route):
    torch.set_num_threads(1)
    records = _requests(DEV)
    assert len(route) == 3 * STEPS * REQUESTS
    numbers = harness.judge(DRIVE, records)
    assert _within(numbers), numbers
    control = gmrf_slabs.Chain(N, 1.0, 128, torch.float32, DEV, store=torch.bfloat16)
    numbers = harness.judge(DRIVE, records, program=control)
    assert not _within(numbers), numbers


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("n", [24, 48])
@pytest.mark.parametrize("dtype, store", [(torch.float64, None), (torch.float32, torch.bfloat16)],
                         ids=["float64", "bf16-storage"])
def test_slab_reference_is_the_reference(n, dtype, store):
    torch.set_num_threads(1)
    whole = gmrf.Chain(n, 1.0, 128, dtype, DEV, store=store)
    slabs = gmrf_slabs.Chain(n, 1.0, 128, dtype, DEV, store=store, slab=5)
    assert [lev.shape for lev in slabs.levels] == [lev.shape for lev in whole.levels]
    assert all(b - a < 5 for a, b in (lev.slabs()[-1] for lev in slabs.levels[:2]))  # ragged
    x0 = torch.randn((n,) * 3, generator=torch.Generator().manual_seed(n), dtype=torch.float64)
    key = 2**40 + n
    x_w, q_w = whole.follow(key, x0, 2)
    before = x0.clone()
    x_s, q_s = slabs.follow(key, x0, 2)
    assert torch.equal(x0, before)  # the start is left as it was
    assert _rel(x_s, x_w) <= 1e-13 and _rel(q_s, q_w) <= 1e-13
    for lev in slabs.levels:
        held = [t for t in vars(lev).values() if isinstance(t, torch.Tensor)]
        assert held and all(t.numel() < lev.n**3 for t in held)


@pytest.mark.cuda
def test_replayed_route_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 64)
    kernels.reset_launch_counts()
    records = _requests("cuda")
    counts = kernels.launch_counts()
    steps = STEPS * REQUESTS
    # the first step runs eagerly, then the step is captured and replayed
    assert counts["chain_2d_staged"] == steps and counts["zero_restrict"] == 2 * steps
    assert counts["chain_step_graph"] == steps - 1 and counts["tail_down"] == 0
    assert counts["chain_down"] == counts["chain_2d"] == 0
    numbers = harness.judge(DRIVE, records)
    assert _within(numbers), numbers
