"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them; ``tests/conftest.py`` imports JAX, so run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Each kernel against its plain twin at small shapes with ragged tiles
(deterministic 1e-5, noisy 1e-4, relative max-norm; the patch sweeps
1e-4 either way), the two patch sweep routes bit for bit, the keyed
chain's deferred form bit for bit against the plain form, the launches
of the general keyed cycle, the keyed Gibbs step and the keyed patch
chain, the marching kernel's chain modes (#1 on its own plans, #5
staged, #4 windowed, #3 from zero) and their bitwise identities, its
tail mode (#2, one launch a call), the marching sweep's two modes
(#9 staged, #8 windowed with the diagonal rebuilt or streamed) bit for
bit against each other and the whole-plane sweeps (#7, #6), the
wrappers' refusals, and the posterior chain step (#1 and #7 with rank-k
corrections) against its materialised form and its deferred form against
the plain chain (1e-3, relative max-norm), with its launches; the
deferred chain replayed from captured CUDA graphs against the eager
deferred chain bit for bit and against ``sample_chain``, with its
launches and the states it returned left alone; ``sample_chain``'s keyed
V(2,2) step (linear and aggregate) replayed against the eager chain bit
for bit, and the graph hierarchy left eager; the 27-point colour sweep
against its twin bit for bit at the 256^3 hierarchy's 27-point levels,
on 17 offsets and on 26 scalars;
the linear hierarchy's Galerkin levels against R A P (1e-5), and its
keyed cycles' launches (fault F3: no chain kernel); the structured Matérn façade's
launches (one #1 and one #2 a chain step) and ``chain.multi_chain`` bit
for bit against separate chains; the kernels on halo-extended blocks with
``row_offset``/``n0_global`` (#7, #8, #9, #1, #4, #5, #3) against their
twins and bit for bit the full-grid kernel's rows, the sharded MGMC
step's launches on two slots of one card, and the row-partitioned mesh
MGMC step against the unsharded one on 1, 2 and 4 slots of one card.  ``chip_smoke.py`` repeats the kernel checks at the 256^3
main-path shapes.
"""

from unittest import mock

import pytest
import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.kernels import _march, _twin, mg_sweep, patch_sweep, rb_gibbs
from parmgmc_tpu_torch.chain import init_chain, sample_chain, sample_chain_deferred
from parmgmc_tpu_torch.kernels.mg_sweep import (
    fused_chain_down_2d,
    fused_chain_down_2d_reference,
    fused_chain_down_2d_staged,
    fused_chain_down_2d_staged_reference,
    fused_chain_down_fd,
    fused_chain_down_fd_reference,
    fused_zero_gibbs_restrict_fd,
    fused_zero_gibbs_restrict_fd_reference,
)
from parmgmc_tpu_torch.kernels.mg_tail import fused_tail_down, tail_down_reference
from parmgmc_tpu_torch.kernels.patch_sweep import (
    fused_patch_sweep_sqfd,
    fused_patch_sweep_sqfd_colourwise,
    fused_patch_sweep_sqfd_reference,
    fused_patch_sweep_sqfd_streamed,
)
from parmgmc_tpu_torch.models.problems import squared_shifted_laplace_fd
from parmgmc_tpu_torch.kernels.rb_gibbs import (
    fused_rb_gibbs_sweep,
    fused_rb_gibbs_sweep_2d,
    fused_rb_gibbs_sweep_2d_reference,
    fused_rb_gibbs_sweep_2d_staged,
    fused_rb_gibbs_sweep_2d_staged_reference,
    fused_rb_gibbs_sweep_fd,
    fused_rb_gibbs_sweep_fd_reference,
    fused_rb_gibbs_sweep_reference,
)
from parmgmc_tpu_torch.operators.stencil import StencilOperator, shifted_laplace_fd
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
from parmgmc_tpu_torch.samplers.patch_gibbs import PatchGibbsSampler

pytestmark = pytest.mark.cuda
V10 = dict(n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rel(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.parametrize("shape", [(16, 24, 96), (10, 6, 34)])
def test_chain_kernel_matches_twin(dev, shape):
    g = torch.Generator(device=dev).manual_seed(4)
    x, b = (torch.randn(*shape, generator=g, device=dev) for _ in range(2))
    z = torch.randn(*(s // 2 for s in shape), generator=g, device=dev)
    h = float((shape[0] - 1) ** 2)
    args = ([-h] * 6, 1.0, h, 1.3, 3, 5)
    for noise in (False, True):
        for bb, zz in ((b, None), (None, z)):
            kw = dict(with_noise=noise, z=zz, with_xsum=True, with_zsum=zz is not None)
            kernels.reset_launch_counts()
            got = fused_chain_down_fd(x, bb, *args, **kw)
            assert kernels.launch_counts()["chain_down"] == 1
            want = fused_chain_down_fd_reference(x, bb, *args, **kw)
            for i, (a, w) in enumerate(zip(got, want)):
                tol = 1e-4 if (noise or i >= 2) else 1e-5
                assert _rel(a, w) <= tol, (noise, bb is None, i)


# n2 % 4 != 0 streams through cp.async, (20, 40, 72) all through TMA,
# (12, 66, 68) z (n2 / 2 = 34) through cp.async and x, b through TMA
@pytest.mark.parametrize("shape", [(36, 40, 70), (12, 66, 34), (20, 40, 72), (12, 66, 68),
                                   (12, 770, 774)])
def test_march_kernel_modes_match_twins(dev, shape):
    """#5 and #4 against their twins and bit for bit against each other;
    #3 against its twin and bit for bit #5 with x = 0."""
    g = torch.Generator(device=dev).manual_seed(9)
    x, b = (torch.randn(*shape, generator=g, device=dev) for _ in range(2))
    z = torch.randn(*(s // 2 for s in shape), generator=g, device=dev)
    h = float((shape[0] - 1) ** 2)
    args = ([-h] * 6, 1.0, h, 1.3, 3, 5)
    zero = torch.zeros_like(x)
    for sweep in ("forward", "backward"):
        for noise in (False, True):
            for bb, zz in ((b, None), (None, z)):
                kw = dict(sweep=sweep, with_noise=noise, z=zz, with_xsum=True, with_zsum=zz is not None)
                kernels.reset_launch_counts()
                st = fused_chain_down_2d_staged(x, bb, *args, **kw)
                wi = fused_chain_down_2d(x, bb, *args, **kw)
                counts = kernels.launch_counts()
                assert counts["chain_2d_staged"] == 1 and counts["chain_2d"] == 1
                for got, twin in ((st, fused_chain_down_2d_staged_reference),
                                  (wi, fused_chain_down_2d_reference)):
                    want = twin(x, bb, *args, **kw)
                    for i, (a, w) in enumerate(zip(got, want)):
                        assert a.shape == w.shape
                        tol = 1e-4 if (noise or i >= 2) else 1e-5
                        assert _rel(a, w) <= tol, (sweep, noise, bb is None, i)
                assert torch.equal(st[0], wi[0]) and torch.equal(st[1], wi[1])
            kw = dict(sweep=sweep, with_noise=noise)
            y, rc = fused_zero_gibbs_restrict_fd(b, *args, **kw)
            assert kernels.launch_counts()["zero_restrict"] == 1
            y_r, rc_r = fused_zero_gibbs_restrict_fd_reference(b, *args, **kw)
            tol = 1e-4 if noise else 1e-5
            assert _rel(y, y_r) <= tol and _rel(rc, rc_r) <= tol
            xpy0, rc0 = fused_chain_down_2d_staged(zero, b, *args, **kw)
            assert torch.equal(y, xpy0) and torch.equal(rc, rc0)
    # b = None streams no b: bit for bit an explicit zero b
    assert torch.equal(fused_chain_down_2d_staged(x, None, *args)[0],
                       fused_chain_down_2d_staged(x, zero, *args)[0])


@pytest.mark.parametrize("shape", [(16, 24, 96), (10, 6, 34)])
def test_march_kernel_matches_chain_kernel(dev, shape):
    """#1 is the marching body on its own plan: bit for bit #5 and #4."""
    g = torch.Generator(device=dev).manual_seed(10)
    x, b = (torch.randn(*shape, generator=g, device=dev) for _ in range(2))
    z = torch.randn(*(s // 2 for s in shape), generator=g, device=dev)
    h = float((shape[0] - 1) ** 2)
    args = ([-h] * 6, 1.0, h, 1.0, 3, 5)
    for sweep in ("forward", "backward"):
        for noise in (False, True):
            for bb, zz in ((b, None), (None, z)):
                kw = dict(sweep=sweep, with_noise=noise, z=zz)
                a = fused_chain_down_fd(x, bb, *args, **kw)
                for fn in (fused_chain_down_2d_staged, fused_chain_down_2d):
                    c = fn(x, bb, *args, **kw)
                    assert torch.equal(c[0], a[0]) and torch.equal(c[1], a[1]), (sweep, noise, bb is None)


@pytest.mark.parametrize("shape", [(16, 24, 96), (36, 40, 70)])
def test_chain_fd_plans_agree_bitwise(dev, shape):
    """#1 on segments of 2 to 16 planes: the same xpy and rc, and partial
    sums that follow each plan."""
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn(*shape, generator=g, device=dev)
    z = torch.randn(*(s // 2 for s in shape), generator=g, device=dev)
    h = float((shape[0] - 1) ** 2)
    args = ([-h] * 6, 1.0, h, 1.3, 3, 5)
    kw = dict(z=z, with_xsum=True, with_zsum=True)
    first = None
    for seg in (2, 4, 16):
        p = mg_sweep.chain_fd_plan(shape, with_z=True)
        plan = _march.MarchPlan(shape=p.shape, strip=p.strip, halo=p.halo, seg=seg, tma=p.tma)
        with mock.patch.object(mg_sweep, "chain_fd_plan", lambda s, with_z=False, p=plan: p):
            out = fused_chain_down_fd(x, None, *args, **kw)
        first = first or out
        assert torch.equal(out[0], first[0]) and torch.equal(out[1], first[1]), seg
        want_x = _twin.tile_sums(out[0], plan.tile)
        want_z = _twin.tile_sums(z, tuple(t // 2 for t in plan.tile))
        assert out[2].shape == want_x.shape == (plan.items,)
        assert _rel(out[2], want_x) <= 1e-4 and _rel(out[3], want_z) <= 1e-4, seg


# ragged levels: rows of 18 and 34 words stream through cp.async, the
# others through TMA; the 4-level hierarchy's first level has several
# segments and strips a level
@pytest.mark.parametrize("shapes", [
    ((20, 12, 36), (10, 6, 18), (5, 3, 9)),
    ((72, 40, 68), (36, 20, 34), (18, 10, 17)),
    ((64, 48, 80), (32, 24, 40), (16, 12, 20), (8, 6, 10), (4, 3, 5)),
])
def test_tail_kernel_matches_twin(dev, shapes):
    """#2 against its twin, one launch a call for every level; from a
    caller's b whose base is not 16-B aligned too (level 0 through
    cp.async)."""
    bl = torch.randn(*shapes[0], generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    params = []
    for shp in shapes[:-1]:
        h = float((shp[0] - 1) ** 2)
        params += [1.0, 1.0 + h / 400.0, h]
    n = bl.numel()
    bo = torch.empty(n + 1, device=dev)[1:].view(bl.shape)
    bo.copy_(bl)
    assert bo.data_ptr() % 16 != 0 and bo.is_contiguous()
    for noise in (False, True):
        for color0 in (0, 1):
            kernels.reset_launch_counts()
            ys, rhs = fused_tail_down(bl, params, 9, 2, color0, shapes, with_noise=noise)
            assert kernels.launch_counts()["tail_down"] == 1
            ys_r, rhs_r = tail_down_reference(bl, params, 9, 2, color0, shapes, with_noise=noise)
            for a, w in zip([*ys, rhs], [*ys_r, rhs_r]):
                assert a.shape == w.shape
                assert _rel(a, w) <= (1e-4 if noise else 1e-5)
            yo, rho = fused_tail_down(bo, params, 9, 2, color0, shapes, with_noise=noise)
            assert all(torch.equal(a, c) for a, c in zip([*ys, rhs], [*yo, rho]))
    assert kernels.launch_counts()["tail_down"] == 2


@pytest.mark.parametrize("shape", [(16, 24, 96), (10, 6, 34)])
def test_sweep_kernels_match_twins(dev, shape):
    g = torch.Generator(device=dev).manual_seed(7)
    x, b, f = (torch.randn(*shape, generator=g, device=dev) for _ in range(3))
    h = float((shape[0] - 1) ** 2)
    op = shifted_laplace_fd(shape, 1.0, device=dev)
    diag = (op.diag * (1.5 + 0.5 * torch.tanh(f))).contiguous()  # a non-FD diagonal
    coeffs = [-h] * 6
    for sweep in ("forward", "backward"):
        for noise in (False, True):
            for bb in (b, None):
                kw = dict(sweep=sweep, with_noise=noise)
                kernels.reset_launch_counts()
                got_fd = fused_rb_gibbs_sweep_fd(x, bb, coeffs, 1.0, h, 1.3, 3, 5, **kw)
                got_st = fused_rb_gibbs_sweep(x, bb, diag, coeffs, 1.3, 3, 5, **kw)
                counts = kernels.launch_counts()
                assert counts["rb_gibbs_fd"] == 1 and counts["rb_gibbs"] == 1
                want_fd = fused_rb_gibbs_sweep_fd_reference(x, bb, coeffs, 1.0, h, 1.3, 3, 5, **kw)
                want_st = fused_rb_gibbs_sweep_reference(x, bb, diag, coeffs, 1.3, 3, 5, **kw)
                tol = 1e-4 if noise else 1e-5
                assert _rel(got_fd, want_fd) <= tol, (sweep, noise, bb is None)
                assert _rel(got_st, want_st) <= tol, (sweep, noise, bb is None)
    zeros = torch.zeros_like(x)
    assert torch.equal(fused_rb_gibbs_sweep_fd(x, None, coeffs, 1.0, h, 1.3, 3, 5),
                       fused_rb_gibbs_sweep_fd(x, zeros, coeffs, 1.0, h, 1.3, 3, 5))


@pytest.mark.parametrize("shape", [(16, 24, 96), (10, 6, 34), (12, 12, 12)])
def test_full_sweep_is_the_large_plane_sweep(dev, shape):
    """#7 = #9 (FD) and #6 = #8 (streamed D) bit for bit at ragged shapes
    below the plane limit, each on its own launch plan."""
    g = torch.Generator(device=dev).manual_seed(12)
    x, b, f = (torch.randn(*shape, generator=g, device=dev) for _ in range(3))
    h = float((shape[0] - 1) ** 2)
    diag = (shifted_laplace_fd(shape, 1.0, device=dev).diag * (1.5 + 0.5 * torch.tanh(f))).contiguous()
    coeffs = [-h] * 6
    for sweep in ("forward", "backward"):
        for noise in (False, True):
            for bb in (b, None):
                kw = dict(sweep=sweep, with_noise=noise)
                r7 = fused_rb_gibbs_sweep_fd(x, bb, coeffs, 1.0, h, 1.3, 3, 5, **kw)
                r9 = fused_rb_gibbs_sweep_2d_staged(x, bb, coeffs, 1.3, 3, 5, fd_params=(1.0, h), **kw)
                assert torch.equal(r7, r9), (sweep, noise, bb is None)
                r6 = fused_rb_gibbs_sweep(x, bb, diag, coeffs, 1.3, 3, 5, **kw)
                r8 = fused_rb_gibbs_sweep_2d(x, bb, diag, coeffs, 1.3, 3, 5, **kw)
                assert torch.equal(r6, r8), (sweep, noise, bb is None)


@pytest.mark.parametrize("shape", [(16, 24, 96), (13, 40, 36)])
def test_full_sweep_plans_agree_bitwise(dev, shape):
    """#7 and #6 on short and long segments: the same bits (the plan moves
    work, not arithmetic)."""
    g = torch.Generator(device=dev).manual_seed(13)
    x, b = (torch.randn(*shape, generator=g, device=dev) for _ in range(2))
    h = float((shape[0] - 1) ** 2)
    diag = (shifted_laplace_fd(shape, 1.0, device=dev).diag * 1.25).contiguous()
    coeffs = [-h] * 6
    outs = {}
    for seg in (1, 2, 5, 16):
        plan = _march.full_plan(shape, 2, row_words=(shape[2],))
        plan = _march.MarchPlan(shape=plan.shape, strip=plan.strip, halo=plan.halo, seg=seg, tma=plan.tma)
        with mock.patch.object(rb_gibbs, "full_sweep_plan", lambda s, p=plan: p):
            outs[seg] = (fused_rb_gibbs_sweep_fd(x, b, coeffs, 1.0, h, 1.3, 3, 5),
                         fused_rb_gibbs_sweep(x, None, diag, coeffs, 1.3, 3, 5, sweep="backward"))
    first = outs[1]
    for seg, (fd, st) in outs.items():
        assert torch.equal(fd, first[0]) and torch.equal(st, first[1]), seg


# n2 % 4 != 0 streams through cp.async, the others through TMA
@pytest.mark.parametrize("shape", [(12, 66, 34), (37, 40, 70), (37, 40, 72), (12, 770, 774)])
def test_sweep_march_modes_match_twins(dev, shape):
    """#9 and #8 (FD and streamed D) against their twins; #9, #8-FD and #7
    bit for bit, #8-streamed and #6 bit for bit (the whole-plane wrappers
    forced to #7 and #6 past the plane limit)."""
    g = torch.Generator(device=dev).manual_seed(11)
    x, b, f = (torch.randn(*shape, generator=g, device=dev) for _ in range(3))
    h = float((shape[0] - 1) ** 2)
    fd = (1.0, h)
    diag = (shifted_laplace_fd(shape, 1.0, device=dev).diag * (1.5 + 0.5 * torch.tanh(f))).contiguous()
    coeffs = [-h] * 6
    for sweep in ("forward", "backward"):
        for noise in (False, True):
            for bb in (b, None):
                kw = dict(sweep=sweep, with_noise=noise)
                kernels.reset_launch_counts()
                st = fused_rb_gibbs_sweep_2d_staged(x, bb, coeffs, 1.3, 3, 5, fd_params=fd, **kw)
                wi = fused_rb_gibbs_sweep_2d(x, bb, None, coeffs, 1.3, 3, 5, fd_params=fd, staged=False, **kw)
                ws = fused_rb_gibbs_sweep_2d(x, bb, diag, coeffs, 1.3, 3, 5, **kw)
                counts = kernels.launch_counts()
                assert counts["rb_gibbs_2d_staged"] == 1 and counts["rb_gibbs_2d"] == 2
                tol = 1e-4 if noise else 1e-5
                want = fused_rb_gibbs_sweep_2d_staged_reference(x, bb, coeffs, 1.3, 3, 5, fd_params=fd, **kw)
                assert _rel(st, want) <= tol, (sweep, noise, bb is None)
                want = fused_rb_gibbs_sweep_2d_reference(x, bb, diag, coeffs, 1.3, 3, 5, **kw)
                assert _rel(ws, want) <= tol, (sweep, noise, bb is None)
                assert torch.equal(st, wi)
                with mock.patch.object(rb_gibbs, "_PLANE_LIMIT", 2**62):  # #7 and #6 at any plane
                    assert torch.equal(st, fused_rb_gibbs_sweep_fd(x, bb, coeffs, *fd, 1.3, 3, 5, **kw))
                    assert torch.equal(ws, fused_rb_gibbs_sweep(x, bb, diag, coeffs, 1.3, 3, 5, **kw))
    zeros = torch.zeros_like(x)
    assert torch.equal(fused_rb_gibbs_sweep_2d_staged(x, None, coeffs, 1.3, 3, 5, fd_params=fd),
                       fused_rb_gibbs_sweep_2d_staged(x, zeros, coeffs, 1.3, 3, 5, fd_params=fd))


@pytest.mark.parametrize("shape", [(11, 12, 13), (16, 10, 128)])
def test_patch_kernels_match_twin(dev, shape):
    """#10 (cooperative) and #11 (per phase) against the twin, and bit for
    bit against each other and the colour-by-colour check."""
    g = torch.Generator(device=dev).manual_seed(8)
    x, b = (torch.randn(*shape, generator=g, device=dev) for _ in range(2))
    k2, h2 = 1.69, float((shape[0] - 1) ** 2)
    for noise in (False, True):
        for bb in (b, None):
            kernels.reset_launch_counts()
            whole = fused_patch_sweep_sqfd(x, bb, k2, h2, 3, 5, with_noise=noise)
            per_phase = fused_patch_sweep_sqfd_streamed(x, bb, k2, h2, 3, 5, with_noise=noise)
            colourwise = fused_patch_sweep_sqfd_colourwise(x, bb, k2, h2, 3, 5, with_noise=noise)
            counts = kernels.launch_counts()
            assert counts["patch_sweep"] == 1 and counts["patch_sweep_streamed"] == 1
            assert counts["patch_sweep_colourwise"] == 1
            want = fused_patch_sweep_sqfd_reference(x, bb, k2, h2, 3, 5, with_noise=noise)
            assert _rel(whole, want) <= 1e-4, (noise, bb is None)
            assert torch.equal(whole, per_phase), (noise, bb is None)
            assert torch.equal(per_phase, colourwise), (noise, bb is None)
    zeros = torch.zeros_like(x)
    assert torch.equal(fused_patch_sweep_sqfd(x, None, k2, h2, 3, 5),
                       fused_patch_sweep_sqfd(x, zeros, k2, h2, 3, 5))


@pytest.mark.parametrize("shape", [(12, 16, 72), (11, 12, 13)])
def test_patch_staging_does_not_depend_on_alignment(dev, shape):
    """#10 and #11 on tensors whose base is not 16-B aligned (the staging's
    __ldcg path) equal the aligned ones (16-B cp.async where n2 % 4 == 0)
    and the colour order bit for bit."""
    g = torch.Generator(device=dev).manual_seed(9)
    n = shape[0] * shape[1] * shape[2]
    x, b = (torch.randn(*shape, generator=g, device=dev) for _ in range(2))
    xo, bo = (torch.empty(n + 1, device=dev)[1:].view(shape) for _ in range(2))
    xo.copy_(x)
    bo.copy_(b)
    assert xo.data_ptr() % 16 != 0 and xo.is_contiguous()
    k2, h2 = 1.69, float((shape[0] - 1) ** 2)
    want = fused_patch_sweep_sqfd_colourwise(x, b, k2, h2, 3, 5)
    for xx, bb in ((x, b), (xo, bo), (xo, None)):
        ref = want if bb is not None else fused_patch_sweep_sqfd_colourwise(x, None, k2, h2, 3, 5)
        assert torch.equal(fused_patch_sweep_sqfd(xx, bb, k2, h2, 3, 5), ref)
        assert torch.equal(fused_patch_sweep_sqfd_streamed(xx, bb, k2, h2, 3, 5), ref)


def test_keyed_patch_chain_launches(dev):
    op = squared_shifted_laplace_fd((16, 10, 128), 40.0, device=dev)
    smp = PatchGibbsSampler.create(op)
    assert smp.sq_fd_params is not None
    kernels.reset_launch_counts()
    st, q = sample_chain(smp, init_chain(smp, 4), None, 6, extract=torch.mean)
    counts = kernels.launch_counts()
    assert counts["patch_sweep"] == 6 and counts["patch_sweep_streamed"] == 0
    assert bool(torch.isfinite(st.x).all()) and bool(torch.isfinite(q).all())


def test_keyed_general_cycle_and_gibbs_launch_the_sweep_kernel(dev):
    op = shifted_laplace_fd((16, 16, 32), 1.0, device=dev)
    smp = MGMCSampler.create(op, n_pre=2, n_post=2, coarsest_size=64, coarsening="aggregate")
    assert len(smp.ops) == 3 and not smp.deferred_eligible()
    kernels.reset_launch_counts()
    st, q = sample_chain(smp, init_chain(smp, 2), None, 5, extract=torch.mean)
    counts = kernels.launch_counts()
    assert counts["rb_gibbs_fd"] == 5 * 4 * 2 and counts["chain_down"] == counts["rb_gibbs"] == 0
    assert bool(torch.isfinite(st.x).all())
    field = StencilOperator(op.offsets, op.coeffs, (op.diag * 1.25).contiguous())
    for o, counter in ((op, "rb_gibbs_fd"), (field, "rb_gibbs")):
        gs = GibbsSampler.create(o, sweep="symmetric")
        kernels.reset_launch_counts()
        st, _ = sample_chain(gs, init_chain(gs, 3), None, 4, extract=torch.mean)
        assert kernels.launch_counts()[counter] == 8
        assert bool(torch.isfinite(st.x).all())


def test_keyed_chain_deferred_is_bitwise(dev):
    op = shifted_laplace_fd((16, 16, 32), 1.0, device=dev)
    smp = MGMCSampler.create(op, n_pre=1, n_post=0, coarsest_size=64, coarsening="aggregate")
    assert len(smp.ops) == 3
    kernels.reset_launch_counts()
    st = init_chain(smp, 6)
    sa, _ = sample_chain(smp, st, None, 6)
    sb, _ = sample_chain_deferred(smp, st, None, 6)
    assert torch.equal(sa.x, sb.x)
    counts = kernels.launch_counts()
    assert counts["chain_down"] == 12 and counts["tail_down"] == 12


def _replay_problem(dev, n, posterior):
    """The aggregate V(1,0) sampler of gmrf_3d(n) and its b: the prior, or
    a posterior on five balls (the benchmark's balls5 mix: sigma^2 0.01,
    radius 0.12, centres 0.15 + 0.7 U and values N(0, 1) from
    default_rng(n))."""
    import numpy as np

    from parmgmc_tpu_torch.models.obs import make_posterior_operator
    from parmgmc_tpu_torch.models.problems import gmrf_3d

    op, b = gmrf_3d(n, 1.0, device=dev), None
    if posterior:
        rng = np.random.default_rng(n)
        op, b = make_posterior_operator(op, 0.01, 0.15 + 0.7 * rng.random((5, 3)), np.full(5, 0.12),
                                        obsvals=rng.standard_normal(5))
    smp = MGMCSampler.create(op, **V10)
    assert smp.deferred_eligible() and smp.n_levels >= 3
    return smp, b


@pytest.mark.parametrize("posterior", [False, True])
@pytest.mark.parametrize("n", [32, 64])
def test_replayed_deferred_chain_is_the_eager_chain(dev, n, posterior):
    """sample_chain_deferred replayed from its captured CUDA graphs, over
    three calls of 20 steps: bit for bit the eager deferred chain (states,
    keys and QOI) and sample_chain (bit for bit on the prior; 1e-3 on the
    posterior, whose rank-k terms sum in another order); each returned
    state unchanged by the later calls; one chain_step_graph a replayed
    step (every step but the first, which runs eagerly and is captured
    after it) and one #1 a step."""
    from parmgmc_tpu_torch import replay

    smp, b = _replay_problem(dev, n, posterior)
    st = init_chain(smp, 2**33 + 7)
    kernels.reset_launch_counts()
    runs = []
    for _ in range(3):
        st, q = sample_chain_deferred(smp, st, b, 20)
        runs.append((st, q, st.x.clone()))
    counts = kernels.launch_counts(plain=False)
    per = dict(rb_gibbs_fd=smp.n_levels - 2) if posterior else dict(tail_down=1)
    want = dict(dict.fromkeys(counts, 0), chain_down=60, chain_step_graph=59,
                **{k: 60 * v for k, v in per.items()})
    assert counts == want, counts
    for st_g, _, copy in runs:
        assert torch.equal(st_g.x, copy)
    st_e = st_p = init_chain(smp, 2**33 + 7)
    with mock.patch.object(replay, "graphs_for", lambda *a: None):
        for st_g, q_g, _ in runs:
            st_e, q_e = sample_chain_deferred(smp, st_e, b, 20)
            st_p, _ = sample_chain(smp, st_p, b, 20)
            assert st_g.key == st_e.key == st_p.key
            assert torch.equal(st_g.x, st_e.x) and torch.equal(q_g, q_e)
            if posterior:
                assert _rel(st_p.x, st_g.x) < 1e-3
            else:
                assert torch.equal(st_p.x, st_g.x)


def _galerkin_levels(dev, n):
    """The 27-point levels of the linear hierarchy of gmrf_3d(n)."""
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.samplers.mgmc import build_hierarchy

    ops, _ = build_hierarchy(gmrf_3d(n, 1.0, device=dev))
    return ops[1:-1]


def _sparse_galerkin_level(op, keep=17):
    """``op`` cut to its first ``keep`` offsets (fields and scalars as they
    were), its diagonal kept: a radius-1 stencil of fewer than 26 offsets."""
    return StencilOperator(op.offsets[:keep], op.coeffs[:keep], op.diag)


def _scalar_galerkin_level(op):
    """``op``'s 26 offsets with every coefficient a scalar (each field's
    mean), its diagonal kept."""
    return StencilOperator(op.offsets, tuple(c if c.ndim == 0 else c.mean() for c in op.coeffs), op.diag)


def _sweep_matches_twin(dev, op, seed):
    """One operator through the 27-point sweep kernel against its twin, bit
    for bit: forward and backward, noise on and off, b given and None; eight
    launches a call; prefix_at gives the by-value draws."""
    from parmgmc_tpu_torch.kernels import galerkin_sweep as gs

    pk = gs.pack(op)
    g = torch.Generator(device=dev).manual_seed(seed)
    x, b = (torch.randn(op.grid_shape, generator=g, device=dev) for _ in range(2))
    for sweep in ("forward", "backward"):
        for noise in (True, False):
            for bb in (b, None):
                want = gs.fused_galerkin_sweep_reference(x, bb, op, 1.0, 3, 8, sweep=sweep,
                                                         with_noise=noise)
                kernels.reset_launch_counts()
                got = gs.fused_galerkin_sweep(x, bb, op, 1.0, 3, 8, sweep=sweep, with_noise=noise,
                                              packed=pk)
                assert kernels.launch_counts()["galerkin_sweep"] == 8
                assert torch.equal(got, want), (op.grid_shape, len(op.offsets), sweep, noise, bb is None)
    at = torch.tensor([_noise_prefix(3, 8)], dtype=torch.int32, device=dev)
    assert torch.equal(gs.fused_galerkin_sweep(x, b, op, 1.0, 3, 8, packed=pk, prefix_at=at),
                       gs.fused_galerkin_sweep(x, b, op, 1.0, 3, 8, packed=pk))


def test_galerkin_sweep_kernel_matches_twin_bitwise(dev):
    """The 27-point colour sweep (csrc/galerkin_sweep.cu) against its twin
    on the card, bit for bit, at every 27-point level of the 256^3 linear
    hierarchy (128^3 ... 16^3) and on an odd extent (17^3)."""
    ops = _galerkin_levels(dev, 256) + _galerkin_levels(dev, 33)[:1]
    assert [o.grid_shape[0] for o in ops] == [128, 64, 32, 16, 17]
    assert all(len(o.offsets) == 26 for o in ops)
    for op in ops:
        _sweep_matches_twin(dev, op, 11)


@pytest.mark.parametrize("kind", ["fewer-offsets", "all-scalars"])
def test_galerkin_sweep_kernel_other_stencils_match_twin_bitwise(dev, kind):
    """The sweep kernel beyond the Galerkin levels, bit for bit against the
    twin at 17^3 and 16^3: a stencil of 17 offsets (padded to 26 with terms
    of coefficient 0.0) and one of 26 offsets whose coefficients are all
    scalars (each read at one index of the pack's scalar array)."""
    for op in (_galerkin_levels(dev, 33)[0], _galerkin_levels(dev, 32)[0]):
        op = _sparse_galerkin_level(op) if kind == "fewer-offsets" else _scalar_galerkin_level(op)
        assert len(op.offsets) == (17 if kind == "fewer-offsets" else 26)
        assert all(c.ndim == 0 for c in op.coeffs) == (kind == "all-scalars")
        _sweep_matches_twin(dev, op, 12)


def _noise_prefix(seed, step):
    """The Galerkin sweep's hash prefix as the int32 word a device slot holds."""
    import numpy as np

    from parmgmc_tpu_torch.kernels import _noise

    return int(np.uint32(_noise.hash_prefix(seed, step, _noise.GALERKIN_DOMAIN)).view(np.int32))


@pytest.mark.parametrize("coarsening", ["linear", "aggregate"])
def test_replayed_sample_chain_is_the_eager_chain(dev, coarsening):
    """sample_chain of the V(2,2) prior at 32^3 (linear: #7, the 27-point
    sweep, three residual and two prolong-add launches a step; aggregate: #7
    at every level, three plain-torch residuals and two prolong-adds),
    replayed from its captured CUDA
    graphs over two calls of 10 steps: bit for bit the eager chain (states,
    keys and QOI); the states it returned left alone; one chain_step_graph
    a replayed step (every step but the first)."""
    from parmgmc_tpu_torch import replay
    from parmgmc_tpu_torch.kernels.galerkin_sweep import LAUNCHES

    smp = MGMCSampler.create(shifted_laplace_fd((32, 32, 32), 1.0, device=dev), n_pre=2, n_post=2,
                             coarsening=coarsening)
    assert smp.keyed_words(0).replayable and not smp.deferred_eligible()
    st = init_chain(smp, 2**35 + 9)
    kernels.reset_launch_counts()
    runs = []
    for _ in range(2):
        st, q = sample_chain(smp, st, None, 10, extract=torch.mean)
        runs.append((st, q, st.x.clone()))
    counts = kernels.launch_counts()
    # aggregate: the fine residual and two levels' in plain torch, two
    # plain prolong-adds (the counters of the plain-torch calls)
    per = (dict(rb_gibbs_fd=4, galerkin_sweep=4 * LAUNCHES, residual_restrict=3, prolong_add=2)
           if coarsening == "linear"
           else dict(rb_gibbs_fd=8, residual_torch=3, prolong_add_torch=2))
    assert counts == dict(dict.fromkeys(counts, 0), chain_step_graph=19,
                          **{k: 20 * v for k, v in per.items()}), counts
    for st_g, _, copy in runs:
        assert torch.equal(st_g.x, copy)
    st_e = init_chain(smp, 2**35 + 9)
    with mock.patch.object(replay, "graphs_for", lambda *a: None):
        for st_g, q_g, _ in runs:
            st_e, q_e = sample_chain(smp, st_e, None, 10, extract=torch.mean)
            assert st_g.key == st_e.key
            assert torch.equal(st_g.x, st_e.x) and torch.equal(q_g, q_e)
    # recorded samples (extract None) are copies, not the graphs' buffers
    _, xs_g = sample_chain(smp, runs[-1][0], None, 3)
    with mock.patch.object(replay, "graphs_for", lambda *a: None):
        _, xs_e = sample_chain(smp, runs[-1][0], None, 3)
    assert torch.equal(xs_g, xs_e)


def test_replayed_aggregate_v22_step_counts_its_plain_torch_calls(dev, monkeypatch):
    """The 768^3 aggregate V(2,2) route in miniature: at 64^3 with the plane
    limit below 64^2, level 0's four sweeps take #9 and 32^3, 16^3 #7; each
    replay credits the step's plain-torch calls, the fine residual and one a
    smoothed level (4) and a prolong-add a smoothed level (3)."""
    monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 64 * 64 - 1)
    smp = MGMCSampler.create(shifted_laplace_fd((64, 64, 64), 1.0, device=dev), n_pre=2,
                             n_post=2, coarsest_size=128, coarsening="aggregate")
    assert smp.n_levels == 4 and smp.keyed_words(0).replayable
    st, _ = sample_chain(smp, init_chain(smp, 2**33 + 5), None, 2, extract=torch.mean)
    kernels.reset_launch_counts()
    st, q = sample_chain(smp, st, None, 6, extract=torch.mean)
    counts = kernels.launch_counts()
    assert counts == dict(dict.fromkeys(counts, 0), chain_step_graph=6, rb_gibbs_2d_staged=4 * 6,
                          rb_gibbs_fd=8 * 6, residual_torch=4 * 6, prolong_add_torch=3 * 6), counts
    assert bool(torch.isfinite(q).all())


def test_graph_hierarchy_is_not_captured(dev):
    """The mesh's graph hierarchy (Gibbs on graph operators: their draws on
    the host) runs sample_chain eagerly: no capture, no chain_step_graph."""
    from parmgmc_tpu_torch import replay
    from parmgmc_tpu_torch.models.mesh import matern_precision_mesh, unit_square_mesh
    from parmgmc_tpu_torch.operators.graph import from_csr

    pts, cells = unit_square_mesh(16)
    smp = MGMCSampler.create(from_csr(matern_precision_mesh(pts, cells, 5.0), device=dev), coarsest_size=16)
    assert not smp.keyed_words(0).replayable
    kernels.reset_launch_counts()
    st, q = sample_chain(smp, init_chain(smp, 3), None, 4, extract=torch.sum)
    assert kernels.launch_counts()["chain_step_graph"] == 0
    assert replay.graphs_for(smp, st.x, None, False) is None
    assert bool(torch.isfinite(st.x).all()) and q.shape == (4,)


def test_capture_outlives_a_dead_samplers_graphs(dev):
    """Graphs of a sampler that died in a reference cycle are collected
    before the next capture, not inside it, where destroying a graph would
    invalidate the capture: with a collection at every allocation the next
    sampler's chain is still replayed, with no warning."""
    import gc
    import warnings

    old, _ = _replay_problem(dev, 32, False)
    sample_chain_deferred(old, init_chain(old, 1), None, 3)
    cycle = [old]
    cycle.append(cycle)
    del old, cycle
    smp, _ = _replay_problem(dev, 32, False)
    kernels.reset_launch_counts()
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            sample_chain_deferred(smp, init_chain(smp, 2), None, 3)
    finally:
        gc.set_threshold(*thresholds)
    assert kernels.launch_counts()["chain_step_graph"] == 2


def test_wrappers_refuse_bad_cuda_input(dev):
    x = torch.zeros(8, 8, 32, device=dev)
    args = ([-49.0] * 6, 1.0, 49.0, 1.0, 1, 2)
    with pytest.raises(TypeError):
        fused_chain_down_fd(x.double(), None, *args)
    with pytest.raises(ValueError):
        fused_chain_down_fd(x.transpose(0, 1), None, *args)
    with pytest.raises(ValueError):
        fused_chain_down_fd(x, torch.zeros(8, 8, 32), *args)
    h = [-49.0] * 6
    with pytest.raises(TypeError):
        fused_rb_gibbs_sweep_fd(x.double(), None, h, 1.0, 49.0, 1.0, 1, 2)
    with pytest.raises(ValueError):
        fused_rb_gibbs_sweep_fd(x.transpose(0, 1), None, h, 1.0, 49.0, 1.0, 1, 2)
    with pytest.raises(ValueError):
        fused_rb_gibbs_sweep(x, None, torch.ones(8, 8, 32), h, 1.0, 1, 2)
    for fn in (fused_chain_down_2d, fused_chain_down_2d_staged):
        with pytest.raises(TypeError):
            fn(x.double(), None, *args)
        with pytest.raises(ValueError):
            fn(x.transpose(0, 1), None, *args)
    with pytest.raises(ValueError):
        fused_zero_gibbs_restrict_fd(x[:, :, :31].contiguous(), *args)
    with pytest.raises(ValueError):
        fused_zero_gibbs_restrict_fd(x.transpose(0, 1), *args)
    with pytest.raises(TypeError):
        fused_rb_gibbs_sweep_2d_staged(x.double(), None, h, 1.0, 1, 2, fd_params=(1.0, 49.0))
    with pytest.raises(ValueError):
        fused_rb_gibbs_sweep_2d_staged(x.transpose(0, 1), None, h, 1.0, 1, 2, fd_params=(1.0, 49.0))
    with pytest.raises(ValueError):
        fused_rb_gibbs_sweep_2d(x, None, torch.ones(8, 8, 32), h, 1.0, 1, 2)
    for fn in (fused_patch_sweep_sqfd, fused_patch_sweep_sqfd_streamed,
               fused_patch_sweep_sqfd_colourwise):
        with pytest.raises(TypeError):
            fn(x.double(), None, 1.0, 49.0, 1, 2)
        with pytest.raises(ValueError):
            fn(x.transpose(0, 1), None, 1.0, 49.0, 1, 2)
        with pytest.raises(ValueError):
            fn(x, torch.zeros(8, 8, 32), 1.0, 49.0, 1, 2)
    long_rows = torch.zeros(2, 2, patch_sweep.MAX_N2 + 1, device=dev)
    with pytest.raises(ValueError):
        fused_patch_sweep_sqfd_streamed(long_rows, long_rows, 1.0, 49.0, 1, 2)


def _posterior(dev):
    """chip_smoke.py phase 19's problem (bench.py's LRC selftest) at half
    its first extent: three ball observations on (8, 16, 128)."""
    import numpy as np

    from parmgmc_tpu_torch.models.obs import make_posterior_operator

    rng = np.random.default_rng(5)
    return make_posterior_operator(shifted_laplace_fd((8, 16, 128), 1.0, device=dev), 0.05,
                                   0.2 + 0.6 * rng.random((3, 3)), np.full(3, 0.2),
                                   rng.standard_normal(3))


@pytest.mark.parametrize("route", ["probed", "b_eff"])
def test_posterior_chain_step_matches_its_oracle(dev, route):
    """The same kernel calls under the same keys: what differs from the
    materialised step is the rank-k algebra alone.  One #1 and one #7 (the
    one level between 0 and the coarsest) a step, no other kernel."""
    import dataclasses

    from parmgmc_tpu_torch.testing import lrc_chain_oracle

    op, f = _posterior(dev)
    smp = MGMCSampler.create(op, **V10)
    assert smp._lrc_chain_eligible() and smp.lrc_aux.probe is not None and smp.n_levels == 3
    if route == "b_eff":
        smp = dataclasses.replace(smp, lrc_aux=dataclasses.replace(smp.lrc_aux, probe=None))
    x = torch.randn(op.grid_shape, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    for b in (f, None):
        kernels.reset_launch_counts()
        _, got = smp.step(3, x, b)
        counts = kernels.launch_counts(plain=False)
        assert counts == dict(dict.fromkeys(counts, 0), chain_down=1, rb_gibbs_fd=1), counts
        assert _rel(got, lrc_chain_oracle(smp, 3, x, b)) < 1e-3, (route, b is None)


def test_posterior_deferred_chain_matches_plain_chain(dev):
    op, f = _posterior(dev)
    smp = MGMCSampler.create(op, **V10)
    st = init_chain(smp, 5)
    sa, qa = sample_chain(smp, st, f, 8, extract=torch.mean)
    sb, qb = sample_chain_deferred(smp, st, f, 8)
    assert _rel(sb.x, sa.x) < 1e-3 and _rel(qb, qa) < 1e-3


def test_linear_galerkin_levels_are_exact_on_the_card(dev):
    """The default (linear) hierarchy of a 32^3 grid: each coarse stencil of
    levels 1 and 2 against R(A(P x)) on three seeded fields (float32,
    1e-5), as chip_smoke.py phase 21 checks at 256^3 and 768^3."""
    from parmgmc_tpu_torch.operators.transfer import GeometricTransfer
    from parmgmc_tpu_torch.samplers.mgmc import build_hierarchy

    ops, transfers = build_hierarchy(shifted_laplace_fd((32, 32, 32), 1.0, device=dev))
    assert [o.grid_shape for o in ops] == [(32,) * 3, (16,) * 3, (8,) * 3]
    assert all(isinstance(t, GeometricTransfer) for t in transfers)
    gen = torch.Generator(device=dev).manual_seed(21)
    for l in (0, 1):
        for _ in range(3):
            x = torch.randn(ops[l + 1].grid_shape, generator=gen, device=dev)
            want = transfers[l].restrict(ops[l].apply(transfers[l].prolong(x)))
            assert _rel(ops[l + 1].apply(x), want) < 1e-5


def test_linear_hierarchy_launches_no_chain_kernel(dev):
    """Fault F3: the V(1,0) cycle shape on a linear hierarchy runs the
    general keyed cycle (one #7 a step, no #1, #2 or #3) and the deferred
    chain refuses it; the default V(2,2) runs four #7 a step (level 0) and
    four 27-point sweeps (level 1); a residual launch a step for the fine
    residual and one a smoothed level, and a prolong-add launch a smoothed
    level; every step but the first is a replay."""
    from parmgmc_tpu_torch.kernels.galerkin_sweep import LAUNCHES

    op = shifted_laplace_fd((16, 16, 32), 1.0, device=dev)
    for kw, per_step in ((dict(n_levels=2, n_pre=1, n_post=0),
                          dict(rb_gibbs_fd=1, residual_restrict=2, prolong_add=1)),
                         (dict(n_pre=2, n_post=2),
                          dict(rb_gibbs_fd=4, galerkin_sweep=4 * LAUNCHES, residual_restrict=3,
                               prolong_add=2))):
        smp = MGMCSampler.create(op, coarsest_size=64, **kw)
        assert not smp.deferred_eligible()
        kernels.reset_launch_counts()
        st, q = sample_chain(smp, init_chain(smp, 1), None, 5, extract=torch.mean)
        counts = kernels.launch_counts(plain=False)
        want = dict(dict.fromkeys(counts, 0), chain_step_graph=4, **{k: 5 * v for k, v in per_step.items()})
        assert counts == want, counts
        assert bool(torch.isfinite(st.x).all()) and bool(torch.isfinite(q).all())
        with pytest.raises(NotImplementedError):
            smp.step_deferred(0, st.x, smp.deferred_init(torch.float32), None)


def test_matern_sampler_runs_the_chain_kernels(dev):
    """The structured Matérn façade at 32^3 with no device argument: on the
    card, one #1 and one #2 launch a step of ``sample`` and of every chain
    of ``sample_chains``, finite QOI traces, and a batched x refused."""
    from parmgmc_tpu_torch.models.matern import MaternSampler

    ms = MaternSampler((32, 32, 32), kappa=1.0, **V10)
    assert ms.op.device.type == "cuda" and ms.sampler.deferred_eligible()
    ms.set_qoi(torch.mean)
    kernels.reset_launch_counts()
    q = ms.sample(6, burnin=2)
    qc = ms.sample_chains(5, n_chains=3)
    counts = kernels.launch_counts(plain=False)
    # every step a replay but the first of the sampler's first chain call
    assert counts == dict(dict.fromkeys(counts, 0), chain_down=8 + 15, tail_down=8 + 15,
                          chain_step_graph=7 + 15), counts
    assert q.shape == (6,) and qc.shape == (3, 5)
    assert bool(torch.isfinite(q).all()) and bool(torch.isfinite(qc).all())
    with pytest.raises(ValueError, match="lax_variant"):
        ms.sampler.step(1, torch.zeros((32, 32, 32, 2), device=dev), None)


def test_multi_chain_is_separate_chains_on_the_card(dev):
    """chain.multi_chain over three kernel chains equals three separate
    sample_chain calls bit for bit (#1 and #2 on every step)."""
    from parmgmc_tpu_torch.chain import ChainState, multi_chain

    smp = MGMCSampler.create(shifted_laplace_fd((32, 32, 32), 1.0, device=dev), **V10)
    g = torch.Generator(device=dev).manual_seed(3)
    x0 = torch.randn(3, 32, 32, 32, generator=g, device=dev)
    ks = (4, 5, 6)
    kernels.reset_launch_counts()
    st, q = multi_chain(lambda s: sample_chain(smp, s, None, 4, extract=torch.mean), 3)(ChainState(x=x0, key=ks))
    assert kernels.launch_counts()["chain_down"] == 12
    for c in range(3):
        st_c, q_c = sample_chain(smp, ChainState(x=x0[c], key=ks[c]), None, 4, extract=torch.mean)
        assert torch.equal(st.x[c], st_c.x) and torch.equal(q[c], q_c)


def _rows_block(a, lo, hi, h):
    """Rows lo - h .. hi + h of a as a fresh tensor, zero rows beyond its
    ends: the halo-extended block of rows lo .. hi."""
    pad = a.new_zeros((h, *a.shape[1:]))
    return torch.cat([pad, a, pad])[lo : hi + 2 * h].contiguous()


# (shape, block rows): TMA rows (n2 % 4 == 0) and cp.async rows, the first,
# an inner and the last block
@pytest.mark.parametrize("shape", [(32, 24, 96), (24, 10, 34)])
def test_kernels_on_shards_match_twins_and_full_grid(dev, shape):
    """#7 (and #8/#9), #1 (and #4/#5) and #3 on halo-extended blocks with
    row_offset / n0_global, noise on: against their twins on the same
    block (1e-4), and the kept rows bit for bit the full-grid kernel."""
    g = torch.Generator(device=dev).manual_seed(11)
    x, b = (torch.randn(*shape, generator=g, device=dev) for _ in range(2))
    n0 = shape[0]
    h2 = float((n0 - 1) ** 2)
    coeffs = [-h2] * 6
    fd = (1.0, h2)
    for lo, hi in ((0, 8), (8, 16), (n0 - 8, n0)):
        for h, kind in ((2, "sweep"), (4, "chain"), (2, "zero")):
            xe, be = _rows_block(x, lo, hi, h), _rows_block(b, lo, hi, h)
            kw = dict(row_offset=lo - h, n0_global=n0)
            if kind == "sweep":
                calls = [
                    (fused_rb_gibbs_sweep_fd, fused_rb_gibbs_sweep_fd_reference,
                     (coeffs, *fd, 1.2, 3, 5), {}),
                    (lambda *a, **k: fused_rb_gibbs_sweep_2d(*a, staged=False, **k),
                     fused_rb_gibbs_sweep_2d_reference, (None, coeffs, 1.2, 3, 5),
                     dict(fd_params=fd)),
                    (fused_rb_gibbs_sweep_2d_staged, fused_rb_gibbs_sweep_2d_staged_reference,
                     (coeffs, 1.2, 3, 5), dict(fd_params=fd)),
                ]
                for fn, ref, args, extra in calls:
                    got = fn(xe, be, *args, sweep="backward", **extra, **kw)
                    assert _rel(got, ref(xe, be, *args, sweep="backward", **extra, **kw)) <= 1e-4
                    full = fn(x, b, *args, sweep="backward", **extra)
                    assert torch.equal(got[h:-h], full[lo:hi]), (ref.__name__, lo)
            elif kind == "chain":
                args = (coeffs, *fd, 1.1, 7, 9)
                for fn, ref in ((fused_chain_down_fd, fused_chain_down_fd_reference),
                                (fused_chain_down_2d, fused_chain_down_2d_reference),
                                (fused_chain_down_2d_staged, fused_chain_down_2d_staged_reference)):
                    got = fn(xe, be, *args, **kw)
                    want = ref(xe, be, *args, **kw)
                    assert max(_rel(a, w) for a, w in zip(got, want)) <= 1e-4, fn.__name__
                    full = fn(x, b, *args)
                    assert torch.equal(got[0][h:-h], full[0][lo:hi]), (fn.__name__, lo)
                    assert torch.equal(got[1][h // 2 : -h // 2], full[1][lo // 2 : hi // 2])
            else:
                args = (coeffs, *fd, 1.1, 7, 9)
                got = fused_zero_gibbs_restrict_fd(be, *args, **kw)
                want = fused_zero_gibbs_restrict_fd_reference(be, *args, **kw)
                assert max(_rel(a, w) for a, w in zip(got, want)) <= 1e-4
                full = fused_zero_gibbs_restrict_fd(b, *args)
                assert torch.equal(got[0][h:-h], full[0][lo:hi])
                assert torch.equal(got[1][1:-1], full[1][lo // 2 : hi // 2])


def test_sharded_step_launches_on_two_slots(dev):
    """make_sharded_mgmc_step on two slots of one card, (32, 8, 256), 3
    levels, min_local=4: levels 0 and 1 sharded, so two #1 and two #3
    launches a step and no other kernel; the noise-on bits equal the
    one-slot step's."""
    from parmgmc_tpu_torch.parallel.fused import make_sharded_mgmc_step
    from parmgmc_tpu_torch.parallel.mesh import make_mesh, shard_array, unshard

    smp = MGMCSampler.create(shifted_laplace_fd((32, 8, 256), 1.0, device=dev), n_levels=3,
                             n_pre=1, n_post=0, coarsening="aggregate")
    x = torch.randn(32, 8, 256, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    outs = []
    for n in (1, 2):
        mesh = make_mesh((n,), devices=["cuda:0"] * n)
        step = make_sharded_mgmc_step(smp, mesh, min_local=4)
        kernels.reset_launch_counts()
        key, xs = 5, shard_array(x, mesh)
        for _ in range(3):
            key, xs = step(key, xs, None)
        counts = kernels.launch_counts(plain=False)
        assert counts == dict(dict.fromkeys(counts, 0), chain_down=3 * n, zero_restrict=3 * n), counts
        outs.append(unshard(xs))
    assert torch.equal(outs[0], outs[1])
    assert bool(torch.isfinite(outs[0]).all())


def test_sharded_graph_step_matches_unsharded_on_slots(dev):
    """Phase 30's parity at a small size: the deterministic row-partitioned
    MGMC step (float64, the Matérn precision of unit_square_mesh(16)) on
    1, 2 and 4 slots of one card equals the unsharded step_with_noise with
    zero noises to 1e-10 relative, both ghost modes; the keyed step with 8
    chains is finite."""
    from parmgmc_tpu_torch.models.mesh import matern_precision_mesh, unit_square_mesh
    from parmgmc_tpu_torch.operators.graph import from_csr
    from parmgmc_tpu_torch.parallel.graph_sharded import make_sharded_graph_mgmc_step
    from parmgmc_tpu_torch.parallel.mesh import make_mesh

    pts, cells = unit_square_mesh(16)
    op = from_csr(matern_precision_mesh(pts, cells, 5.0), device=dev)
    smp = MGMCSampler.create(op, coarsest_size=16)
    g = torch.Generator(device=dev).manual_seed(30)
    x = torch.randn(op.n, generator=g, dtype=torch.float64, device=dev)
    b = torch.randn(op.n, generator=g, dtype=torch.float64, device=dev)

    def zeros(s):
        if isinstance(s, tuple):
            return torch.zeros(s, dtype=torch.float64, device=dev)
        return {k: zeros(v) for k, v in s.items()} if isinstance(s, dict) else [zeros(v) for v in s]

    ref = smp.step_with_noise(x, b, zeros(smp.noise_shapes()))
    for n in (1, 2, 4):
        mesh = make_mesh((n,), devices=["cuda:0"] * n)
        for mode in ("neighbor", "allgather"):
            step, spec, layout = make_sharded_graph_mgmc_step(smp, mesh, coords=pts, with_noise=False,
                                                              ghost_mode=mode)
            _, out = step(0, layout.shard(x), layout.shard(b))
            got = layout.unshard(out)
            assert float((got - ref).abs().max() / ref.abs().max()) < 1e-10, (n, mode)
    step, spec, layout = make_sharded_graph_mgmc_step(smp, mesh, coords=pts, n_chains=8)
    _, out = step(1, layout.shard(torch.zeros((op.n, 8), dtype=torch.float64, device=dev)), layout.shard(b))
    assert all(o.shape == (spec.n_local, 8) and bool(torch.isfinite(o).all()) for o in out)
