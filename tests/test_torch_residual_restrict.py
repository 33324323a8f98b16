"""The fused residual and restriction (``kernels.residual_restrict``) and
the MGMC sampler's dispatch to it.

CPU (float32 unless stated):

* the twin is the expression it replaces, ``restrict(b - A x)`` and
  ``b - A x`` (b None: zeros), on the 7-point and 27-point levels of even
  and odd grids; the wrapper runs it for CPU tensors;
* the kernel's view of an operator: scalars and fields in offset order,
  D rebuilt from (kappa2, hinv2) only where that gives its bits;
* the dispatch rule takes a 3D float32 stencil under the linear transfer
  and refuses 2D, float64, LRC, aggregate and sparse transfers and chain
  dims; ``lax_variant`` drops the packs;
* the general keyed step through the sampler's helper is the step of the
  inline expressions it replaced, bit for bit (16^3 V(2,2)), and so is
  ``fmg_init``.

On the card (marker ``cuda``; ``python -m pytest
tests/test_torch_residual_restrict.py -m cuda --noconftest -q``): the
kernel against its twin bit for bit on every level of the 64^3 and 33^3
linear hierarchies and on stencils off them (each variant of the
kernel), both forms, b given and None; the wrapper's refusals; the replayed linear chain against the eager one with its
launches.
"""

import dataclasses
from unittest import mock

import pytest
import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.chain import init_chain, sample_chain
from parmgmc_tpu_torch.kernels import residual_restrict as rr
from parmgmc_tpu_torch.models.obs import make_posterior_operator
from parmgmc_tpu_torch.models.problems import gmrf_2d, gmrf_3d
from parmgmc_tpu_torch.operators import stencil as st
from parmgmc_tpu_torch.operators.graph import bcast
from parmgmc_tpu_torch.operators.transfer import (
    AggregateTransfer,
    GeometricTransfer,
    SparseTransfer,
)
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler, build_hierarchy
from parmgmc_tpu_torch.samplers.registry import lax_variant

DEV = "cpu"
F32 = torch.float32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _levels(n, dtype=F32, device=DEV):
    """(ops, transfers) of the linear hierarchy of gmrf_3d(n) down to 4^3."""
    return build_hierarchy(gmrf_3d(n, 1.0, dtype=dtype, device=device), coarsest_size=64)


def _fields(shape, seed, device=DEV):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, dtype=F32, device=device) for _ in range(2))


def _old_residual(self, l, x, b, restrict=True):
    """The inline expressions the sampler's helper replaced."""
    r = (torch.zeros_like(x) if b is None else bcast(b, x)) - self.ops[l].apply(x)
    return self.transfers[l].restrict(r) if restrict else r


@pytest.mark.parametrize("n", [12, 13])
def test_twin_is_the_expression_it_replaces(n):
    ops, transfers = _levels(n)
    assert [len(o.offsets) for o in ops[:2]] == [6, 26]
    for op, tr in zip(ops, transfers):
        x, b = _fields(op.grid_shape, n)
        for bb in (b, None):
            r = (torch.zeros_like(x) if bb is None else bb) - op.apply(x)
            assert torch.equal(rr.residual_restrict_reference(x, bb, op, restrict=False), r)
            assert torch.equal(rr.residual_restrict_reference(x, bb, op), tr.restrict(r))
            assert torch.equal(rr.residual_restrict(x, bb, op, packed=rr.pack(op)), tr.restrict(r))


def test_pack_reads_scalars_fields_and_the_fd_diagonal():
    ops, _ = _levels(12)
    fd = rr.pack(ops[0])
    assert all(f is None for f in fd.fields) and fd.diag is None
    k2, h2 = (torch.tensor(v, dtype=F32) for v in fd.fd)
    assert torch.equal(k2 + h2 * st.link_count(ops[0].grid_shape, F32, DEV), ops[0].diag)
    assert fd.scalars == tuple(float(c) for c in ops[0].coeffs)
    g = rr.pack(ops[1])
    assert g.offsets == ops[1].offsets and g.diag is ops[1].diag
    assert sum(f is not None for f in g.fields) == 18
    for c, f, s in zip(ops[1].coeffs, g.fields, g.scalars):
        assert (f is c and s == 0.0) if c.ndim else (f is None and s == float(c))
    # a diagonal that the FD scalars do not rebuild bit for bit is read as a field
    bumped = st.StencilOperator(ops[0].offsets, ops[0].coeffs, ops[0].diag.clone())
    bumped.diag[3, 4, 5] = torch.nextafter(bumped.diag[3, 4, 5], torch.tensor(1e9))
    assert rr.pack(bumped).diag is bumped.diag
    lazy = st.fd_stencil((12, 12, 12), 1.0, 121.0, device=DEV, lazy=True)
    p = rr.pack(lazy)
    assert p.diag is None and p.fd == lazy.fd_params()
    k2, h2 = (torch.tensor(v, dtype=F32) for v in p.fd)
    assert torch.equal(k2 + h2 * lazy.links(), lazy.diag)


def _level_cases():
    ops, transfers = _levels(16)
    ops64, tr64 = _levels(16, torch.float64)
    post, _ = make_posterior_operator(ops[0], 0.01, [[0.5, 0.5, 0.5]], [0.2])
    op2 = gmrf_2d(16, 1.0, F32, device=DEV)
    sparse = SparseTransfer(*(torch.zeros((1, 1)) for _ in range(4)))
    return {
        "fd-star": (ops[0], transfers[0], True),
        "galerkin": (ops[1], transfers[1], True),
        "2d": (op2, GeometricTransfer(fine_shape=op2.grid_shape), False),
        "float64": (ops64[0], tr64[0], False),
        "lrc": (post, transfers[0], False),
        "aggregate": (ops[0], AggregateTransfer(fine_shape=ops[0].grid_shape), False),
        "sparse": (ops[0], sparse, False),
        "another-grid": (ops[1], transfers[0], False),
    }


@pytest.mark.parametrize("case", ["fd-star", "galerkin", "2d", "float64", "lrc", "aggregate", "sparse",
                                  "another-grid"])
def test_dispatch_rule(case):
    op, tr, want = _level_cases()[case]
    assert rr.supported(op, tr) == want


def test_takes_no_chain_dims_and_grid_shaped_b():
    op = _levels(12)[0][1]
    x, b = _fields(op.grid_shape, 1)
    assert rr.takes(op, x) and rr.takes(op, x, b)
    assert not rr.takes(op, x[..., None].expand(6, 6, 6, 3))
    assert not rr.takes(op, x.double()) and not rr.takes(op, x, b[0])


def test_sampler_packs_follow_the_rule():
    smp = MGMCSampler.create(gmrf_3d(16, device=DEV), n_pre=2, n_post=2, coarsest_size=16)
    assert [o.grid_shape[0] for o in smp.ops] == [16, 8, 4]
    assert all(p is not None for p in smp.residual_packs)
    assert lax_variant(smp).residual_packs is None
    agg = MGMCSampler.create(gmrf_3d(16, device=DEV), n_pre=2, n_post=2, coarsest_size=16,
                             coarsening="aggregate")
    assert agg.residual_packs is None
    post, _ = make_posterior_operator(gmrf_3d(16, device=DEV), 0.01, [[0.5, 0.5, 0.5]], [0.2])
    assert MGMCSampler.create(post, n_pre=2, n_post=2, coarsest_size=16).residual_packs is None
    two = MGMCSampler.create(gmrf_2d(16, 1.0, F32, device=DEV), n_pre=2, n_post=2, coarsest_size=16)
    assert two.residual_packs is None


@pytest.mark.parametrize("b_on", [False, True])
def test_general_step_is_the_inline_step(b_on):
    smp = MGMCSampler.create(gmrf_3d(16, device=DEV), n_pre=2, n_post=2, coarsest_size=16)
    x, b = _fields(smp.grid_shape, 4)
    b = b if b_on else None
    kernels.reset_launch_counts()
    key, got = smp.step(2**33 + 5, x, b)
    assert kernels.launch_counts()["residual_restrict"] == 0  # the twin on the CPU
    with mock.patch.object(MGMCSampler, "_residual", _old_residual):
        key2, want = smp.step(2**33 + 5, x, b)
    assert key == key2 and torch.equal(got, want)
    old = dataclasses.replace(smp, residual_packs=None)
    assert torch.equal(old.step(2**33 + 5, x, b)[1], want)


def test_fmg_init_is_the_inline_start():
    smp = MGMCSampler.create(gmrf_3d(16, device=DEV), n_pre=1, n_post=1, coarsest_size=16)
    b = _fields(smp.grid_shape, 2)[0]
    key, got = smp.fmg_init(77, b)
    with mock.patch.object(MGMCSampler, "_residual", _old_residual):
        assert torch.equal(smp.fmg_init(77, b)[1], got)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 33])
def test_kernel_is_its_twin_bit_for_bit(dev, n):
    ops, transfers = _levels(n, device=dev)
    kernels.reset_launch_counts()
    calls = 0
    for l, (op, tr) in enumerate(zip(ops, transfers)):
        assert rr.supported(op, tr)
        pack = rr.pack(op)
        assert (pack.diag is None) == (l == 0)
        x, b = _fields(op.grid_shape, 10 + l, dev)
        for restrict in (True, False):
            for bb in (b, None):
                want = rr.residual_restrict_reference(x, bb, op, restrict=restrict)
                got = rr.residual_restrict(x, bb, op, restrict=restrict, packed=pack)
                calls += 1
                assert torch.equal(got, want), (l, op.grid_shape, restrict, bb is None)
    assert kernels.launch_counts()["residual_restrict"] == calls


def _other_stencils(device):
    """Stencils off the GMRF hierarchy, one for each variant of the kernel
    and diagonal: a 27-point level with a third of its offsets dropped, the
    star with one coefficient field, the star with a diagonal that is not
    link-count FD, the star with its offsets in another order."""
    ops, _ = _levels(17, device=device)
    g, fd = ops[1], ops[0]
    keep = [m for m in range(26) if m % 3]
    field = tuple(c if m else torch.full(fd.grid_shape, float(c), device=device)
                  for m, c in enumerate(fd.coeffs))
    return {
        "galerkin-subset": st.StencilOperator(tuple(g.offsets[m] for m in keep),
                                              tuple(g.coeffs[m] for m in keep), g.diag),
        "star-field": st.StencilOperator(fd.offsets, field, fd.diag),
        "star-diag": st.StencilOperator(fd.offsets, fd.coeffs, (fd.diag * 1.25).contiguous()),
        "star-reordered": st.StencilOperator(fd.offsets[::-1], fd.coeffs[::-1], fd.diag),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["galerkin-subset", "star-field", "star-diag", "star-reordered"])
def test_kernel_on_other_stencils(dev, case):
    op = _other_stencils(dev)[case]
    pack = rr.pack(op)
    assert (pack.diag is None) == (case == "star-reordered")
    x, b = _fields(op.grid_shape, 3, dev)
    for restrict in (True, False):
        for bb in (b, None):
            want = rr.residual_restrict_reference(x, bb, op, restrict=restrict)
            assert torch.equal(rr.residual_restrict(x, bb, op, restrict=restrict, packed=pack), want)


@pytest.mark.cuda
def test_wrapper_refuses_bad_input(dev):
    ops, _ = _levels(16, device=dev)
    op = ops[1]
    x, b = _fields(op.grid_shape, 1, dev)
    with pytest.raises(TypeError):
        rr.residual_restrict(x.double(), b, op)
    with pytest.raises(ValueError):
        rr.residual_restrict(x.transpose(0, 1), b, op)
    with pytest.raises(ValueError):
        rr.residual_restrict(x[:-1], b[:-1], op)
    with pytest.raises(ValueError):
        rr.residual_restrict(x, b[0], op)
    with pytest.raises(ValueError):
        op2 = gmrf_2d(16, 1.0, F32, device=dev)
        rr.residual_restrict(torch.zeros(op2.grid_shape, device=dev), None, op2)


@pytest.mark.cuda
def test_replayed_linear_chain_is_the_eager_chain(dev):
    from parmgmc_tpu_torch import replay

    smp = MGMCSampler.create(gmrf_3d(32, device=dev), n_pre=2, n_post=2)
    assert [o.grid_shape[0] for o in smp.ops] == [32, 16, 8]
    kernels.reset_launch_counts()
    st0 = init_chain(smp, 2**35 + 1)
    sa, qa = sample_chain(smp, st0, None, 6, extract=torch.mean)
    counts = kernels.launch_counts()
    assert counts["residual_restrict"] == 6 * 3 and counts["chain_step_graph"] == 5
    with mock.patch.object(replay, "graphs_for", lambda *a: None):
        sb, qb = sample_chain(smp, st0, None, 6, extract=torch.mean)
        with mock.patch.object(MGMCSampler, "_residual", _old_residual):
            sc, _ = sample_chain(smp, st0, None, 6, extract=torch.mean)
    assert torch.equal(sa.x, sb.x) and torch.equal(qa, qb) and torch.equal(sb.x, sc.x)
