"""The 27-point colour sweep (``kernels.galerkin_sweep``) and the general
keyed cycle on its words (CPU, float32 unless stated).

* the twin is the sublattice sweep of ``samplers.sor`` on
  b + sqrt((2 - omega)/omega) sqrt(D) eta_hash, bit for bit, at 8^3 and
  12^3, forward and backward, on scalar and on field coefficients; the
  wrapper runs it for CPU tensors; the colour-major pack and its array
  of 26 scalars, 0.0 past a stencil's offsets;
* ``GibbsSampler`` routes 3D float32 27-point stencils to the kernel
  (one launch word a half-sweep, under the Galerkin noise domain) and
  keeps float64, 2D and star-with-fields operators on the plain route;
  its keyed step is the twin on its words;
* ``MGMCSampler.keyed_words`` of the general cycle: the step on its words
  (``step_from`` through a cursor) is bit for bit the cycle keyed on the
  host (``_cycle_general``), on linear, aggregate, W and posterior
  hierarchies, and only plain-route levels make the words unreplayable;
* the 16^3 linear V(2,2) keyed chain against the benchmark's float64
  reference (``portbench/reference/gmrf_galerkin.py``) within the limits
  of the cell ``gmrf256-v22-linear``.
"""

import itertools
import json
import os
import sys

import pytest
import torch

from parmgmc_tpu_torch import keys, kernels
from parmgmc_tpu_torch.chain import init_chain, sample_chain
from parmgmc_tpu_torch.kernels import _noise, _twin, galerkin_sweep
from parmgmc_tpu_torch.models.problems import gmrf_2d, gmrf_3d
from parmgmc_tpu_torch.operators import stencil as st
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler, build_hierarchy
from parmgmc_tpu_torch.samplers.registry import lax_variant
from parmgmc_tpu_torch.samplers.sor import sor_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cpu"
F32 = torch.float32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _galerkin_level(n, dtype=F32):
    """Level 1 of the linear hierarchy of gmrf_3d(2n - 1 or 2n): a 27-point
    stencil, 18 of its coefficients fields and 8 scalars."""
    ops, _ = build_hierarchy(gmrf_3d(2 * n, 1.0, dtype=dtype, device=DEV), n_levels=2)
    assert ops[1].grid_shape == (n, n, n)
    return ops[1]


def _scalar_level(n):
    """A 27-point stencil with 26 scalar coefficients (diagonally dominant)."""
    offs = tuple(o for o in itertools.product((-1, 0, 1), repeat=3) if any(o))
    coeffs = tuple(torch.tensor(-0.1 - 0.01 * i, dtype=F32) for i in range(26))
    return st.StencilOperator(offs, coeffs, torch.full((n, n, n), 12.0, dtype=F32))


def _fields(n, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, n, n), generator=g, dtype=F32) for _ in range(2))


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("kind", ["scalar", "field"])
@pytest.mark.parametrize("sweep", ["forward", "backward"])
@pytest.mark.parametrize("n", [8, 12])
def test_twin_is_the_sublattice_sweep_on_the_hashed_rhs(n, sweep, kind, omega):
    op = _scalar_level(n) if kind == "scalar" else _galerkin_level(n)
    assert galerkin_sweep.supported(op)
    assert any(c.ndim == 3 for c in op.coeffs) == (kind == "field")
    x, b = _fields(n, n)
    prefix = _noise.hash_prefix(5, 9, _noise.GALERKIN_DOMAIN)
    eta = _noise.eta_hash(prefix, _twin.flat_index((n, n, n), DEV), F32)
    scale = _twin.noise_factor(omega, F32) * torch.sqrt(op.diag)
    want = sor_sweep(op, b + scale * eta, x, omega, sweep)
    got = galerkin_sweep.fused_galerkin_sweep_reference(x, b, op, omega, 5, 9, sweep=sweep)
    assert torch.equal(got, want)
    assert torch.equal(galerkin_sweep.fused_galerkin_sweep(x, b, op, omega, 5, 9, sweep=sweep), want)
    zero_b = galerkin_sweep.fused_galerkin_sweep_reference(x, None, op, omega, 5, 9, sweep=sweep)
    assert torch.equal(zero_b, sor_sweep(op, torch.zeros_like(b) + scale * eta, x, omega, sweep))
    quiet = galerkin_sweep.fused_galerkin_sweep_reference(x, b, op, omega, 5, 9, sweep=sweep,
                                                          with_noise=False)
    assert torch.equal(quiet, sor_sweep(op, b, x, omega, sweep))


def test_pack_is_colour_major():
    op = _galerkin_level(7)  # odd extent: colours of unequal sizes
    p = galerkin_sweep.pack(op)
    assert p.offsets == op.offsets and len(p.slots) == 26
    assert p.fields.shape == (18, 7**3) and p.diag.shape == (7**3,)
    for m, (c, slot, s) in enumerate(zip(op.coeffs, p.slots, p.scalars_at.tolist())):
        if c.ndim == 0:
            assert slot == -1 and s == float(c)
            continue
        at = 0
        for colour in range(8):
            q = ((colour >> 2) & 1, (colour >> 1) & 1, colour & 1)
            block = c[q[0]::2, q[1]::2, q[2]::2].reshape(-1)
            assert torch.equal(p.fields[slot, at:at + block.numel()], block), (m, colour)
            at += block.numel()
        assert at == 7**3


def _seventeen_offsets(n):
    """A hand-made radius-1 stencil of 17 offsets, every third coefficient
    a field and the others scalars."""
    offs = tuple(o for o in itertools.product((-1, 0, 1), repeat=3) if any(o))[:17]
    g = torch.Generator().manual_seed(17)
    coeffs = tuple(-0.1 - 0.01 * torch.rand((n, n, n), generator=g, dtype=F32) if m % 3 == 0
                   else torch.tensor(-0.1 - 0.01 * m, dtype=F32) for m in range(17))
    return st.StencilOperator(offs, coeffs, torch.full((n, n, n), 12.0, dtype=F32))


@pytest.mark.parametrize("kind", ["galerkin-33", "hand-17"])
def test_pack_scalar_array_and_variant_rule(kind):
    """The pack's scalar array holds 26 float32 values: each offset's scalar
    where its slot is -1, 0.0 where a field and past the offsets, so that
    the kernel's loop over 26 offsets adds +-0 for each offset a stencil
    lacks (the CPU wrapper runs the twin and counts no launch)."""
    if kind == "galerkin-33":
        ops, _ = build_hierarchy(gmrf_3d(33, 1.0, device=DEV), n_levels=2)
        op = ops[1]
    else:
        op = _seventeen_offsets(9)
    p = galerkin_sweep.pack(op)
    assert len(p.offsets) == (26 if kind == "galerkin-33" else 17)
    assert p.scalars_at.shape == (26,) and p.scalars_at.dtype == F32
    assert p.scalars_at.device == op.diag.device
    assert -1 in p.slots and any(s >= 0 for s in p.slots)
    for m in range(26):
        scalar = m < len(p.slots) and p.slots[m] == -1
        want = float(op.coeffs[m].to(F32)) if scalar else 0.0
        assert float(p.scalars_at[m]) == want, m
    kernels.reset_launch_counts()
    x = torch.randn(op.grid_shape, generator=torch.Generator().manual_seed(3), dtype=F32)
    assert torch.equal(galerkin_sweep.fused_galerkin_sweep(x, None, op, 1.0, 5, 9, packed=p),
                       galerkin_sweep.fused_galerkin_sweep_reference(x, None, op, 1.0, 5, 9))
    assert kernels.launch_counts()["galerkin_sweep"] == 0


def test_routes():
    op = _galerkin_level(8)
    smp = GibbsSampler.create(op)
    assert smp.has_kernel and smp.route == "fused_galerkin_sweep" and smp.galerkin
    assert smp.galerkin_pack is None  # made on the card only
    words = keys.Words()
    smp.step_words(3, words)
    assert [k for k, _ in words.entries] == ["launch"] and words.replayable
    assert words.entries[0][1][2] == (_noise.GALERKIN_DOMAIN,)
    sym = keys.Words()
    GibbsSampler.create(op, sweep="symmetric").step_words(3, sym)
    assert [v[1] for _, v in sym.entries] == [words.entries[0][1][1], words.entries[0][1][1] + 1]
    assert lax_variant(smp).route == "torch"
    for other in (_galerkin_level(8, torch.float64), gmrf_2d(16, 1.0, F32, device=DEV),
                  st.StencilOperator(st.star_offsets(3),
                                     tuple(torch.full((8, 8, 8), -1.0) for _ in range(6)), op.diag)):
        g = GibbsSampler.create(other)
        assert not g.has_kernel and g.route == "torch"
        w = keys.Words()
        g.step_words(3, w)
        assert not w.replayable


@pytest.mark.parametrize("sweep", ["forward", "symmetric"])
def test_keyed_gibbs_step_is_the_twin_on_its_words(sweep):
    op = _galerkin_level(8)
    smp = GibbsSampler.create(op, sweep=sweep)
    x, b = _fields(8, 3)
    key2, got = smp.step(2**40 + 3, x, b)
    key, seed, extra = keys.draw_pair(2**40 + 3)
    want = x
    for i, d in enumerate(("forward", "backward") if sweep == "symmetric" else ("forward",)):
        want = galerkin_sweep.fused_galerkin_sweep_reference(want, b, op, 1.0, seed, extra * 2 + i,
                                                             sweep=d)
    assert key2 == key and torch.equal(got, want)


def _posterior():
    import numpy as np

    from parmgmc_tpu_torch.models.obs import make_posterior_operator

    post = make_posterior_operator(gmrf_3d(16, 1.0, F32, device=DEV), 0.05,
                                   np.array([[0.3, 0.4, 0.5], [0.6, 0.3, 0.7]]), np.full(2, 0.25),
                                   obsvals=np.array([1.0, -0.5]))
    return post, dict(n_pre=2, n_post=2, coarsest_size=64)


CYCLES = {
    "linear-V22": lambda: (gmrf_3d(16, 1.0, F32, device=DEV), dict(n_pre=2, n_post=2, coarsest_size=64)),
    "linear-V10": lambda: (gmrf_3d(16, 1.0, F32, device=DEV), dict(n_pre=1, n_post=0, coarsest_size=64)),
    "aggregate-V22": lambda: (gmrf_3d(16, 1.0, F32, device=DEV),
                              dict(n_pre=2, n_post=2, coarsest_size=64, coarsening="aggregate")),
    "linear-W11-sym": lambda: (gmrf_3d(16, 1.0, F32, device=DEV),
                               dict(n_pre=1, n_post=1, coarsest_size=64, gamma=2, sweep="symmetric")),
    "linear-posterior": _posterior,
    "linear-f64": lambda: (gmrf_3d(16, 1.0, torch.float64, device=DEV),
                           dict(n_pre=2, n_post=2, coarsest_size=64)),
    "2d": lambda: (gmrf_2d(32, 1.0, F32, device=DEV), dict(n_pre=2, n_post=2, coarsest_size=32)),
}
REPLAYABLE = {"linear-V22", "linear-V10", "aggregate-V22", "linear-W11-sym", "linear-posterior"}


@pytest.mark.parametrize("cycle", sorted(CYCLES))
def test_general_words_step_is_the_host_keyed_cycle(cycle):
    op, kw = CYCLES[cycle]()
    b = None
    if isinstance(op, tuple):
        op, b = op
    smp = MGMCSampler.create(op, **kw)
    assert not smp.deferred_eligible()
    x = torch.randn(smp.grid_shape, generator=torch.Generator().manual_seed(4), dtype=smp.dtype)
    key = 2**45 + 11
    words = smp.keyed_words(key)
    assert words.replayable == (cycle in REPLAYABLE)
    cur = words.cursor()
    got = smp.step_from(cur, x, b)
    cur.close()
    key2, sub = keys.split(key)
    r = (torch.zeros_like(x) if b is None else b) - smp.fine_op.apply(x)
    want = x + smp._cycle_general(0, r, sub)
    assert words.key == key2 and torch.equal(got, want)
    key3, stepped = smp.step(key, x, b)
    assert key3 == key2 and torch.equal(stepped, want)


def test_linear_v22_chain_matches_the_reference():
    """The 16^3 V(2,2) (levels 16^3, 8^3 on the 27-point twin, 4^3) keyed
    chain of the port, 16 steps, against the float64 reference followed
    from the same start and key, within the cell's limits."""
    sys.path.insert(0, ROOT)
    from portbench.reference import gmrf_galerkin

    limits = json.load(open(os.path.join(ROOT, "portbench", "workloads",
                                         "gmrf256-v22-linear.json")))["limits"]
    smp = MGMCSampler.create(gmrf_3d(16, 1.0, F32, device=DEV), n_pre=2, n_post=2, coarsest_size=64)
    assert [o.grid_shape[0] for o in smp.ops] == [16, 8, 4]
    assert [s.route for s in smp.smoothers] == ["fused_rb_gibbs_sweep_fd", "fused_galerkin_sweep"]
    start = init_chain(smp, 2**33 + 5)
    start = start._replace(x=next(_fields(16, 8)) * 0.01)
    end, q = sample_chain(smp, start, None, 16, extract=torch.mean)
    ref = gmrf_galerkin.Chain(16, 1.0, 64, 2, 2, 1.0, torch.float64, DEV)
    xr, qr = ref.follow(start.key, start.x, 16)
    state_gap = float((end.x.double() - xr).abs().max() / xr.abs().max())
    qoi_gap = float((q.double() - qr).abs().max() / qr.abs().max())
    assert state_gap <= limits["state_gap"] and qoi_gap <= limits["qoi_gap"], (state_gap, qoi_gap)
    assert state_gap < 1e-5


def test_span_of_the_27_point_sweep():
    """A linear V(2,2) step opens ``pmg.galerkin.sweep`` once a half-sweep of
    a 27-point level, inside the general cycle's ``pmg.mgmc.smooth``."""
    from torch.profiler import ProfilerActivity, profile

    from parmgmc_tpu_torch import profiling

    smp = MGMCSampler.create(gmrf_3d(16, 1.0, F32, device=DEV), n_pre=2, n_post=2, coarsest_size=64)
    prev = profiling.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sample_chain(smp, init_chain(smp, 3), None, 1)
    finally:
        profiling.enable(prev)
    evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events() if e.name().startswith("pmg."))
    sweeps = [(s, e) for s, e, n in evs if n == "pmg.galerkin.sweep"]
    smooth = [(s, e) for s, e, n in evs if n == "pmg.mgmc.smooth"]
    assert len(sweeps) == 4
    assert all(any(a <= s and e <= b for a, b in smooth) for s, e in sweeps)
