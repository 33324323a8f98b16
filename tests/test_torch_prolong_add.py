"""The fused prolong-add (``kernels.prolong_add``) and
``GeometricTransfer.prolong_add``'s dispatch to it.

CPU (float32 unless stated):

* the twin is the expression it replaces, ``y + prolong(z, y.shape)``,
  on even, odd and mixed extents, into a new tensor, a separate buffer
  and y itself; the wrapper runs it for CPU tensors;
* ``takes`` accepts the 3D float32 grid and refuses 2D grids, float64,
  chain dims, wrong coarse shapes and unusable ``out`` buffers;
* ``GeometricTransfer.prolong_add`` on the CPU is the plain expression and
  launches nothing; ``lax_variant`` turns the transfers to plain torch.

On the card (marker ``cuda``; ``python -m pytest
tests/test_torch_prolong_add.py -m cuda --noconftest -q``): the kernel
against its twin bit for bit at the 256^3 V(2,2) step's five shapes and
at odd, mixed and misaligned ones, in all three ``out`` forms, also on
subnormal and large values; the wrapper's refusals; the replayed linear
chain against the same steps with the kernel's twin in its place.
"""

from unittest import mock

import pytest
import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.chain import init_chain, sample_chain
from parmgmc_tpu_torch.kernels import prolong_add as pa
from parmgmc_tpu_torch.models.problems import gmrf_3d
from parmgmc_tpu_torch.operators import stencil as st
from parmgmc_tpu_torch.operators.transfer import AggregateTransfer, GeometricTransfer
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
from parmgmc_tpu_torch.samplers.registry import lax_variant

DEV = "cpu"
F32 = torch.float32
OUTS = ["none", "separate", "y"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fields(shape, seed, device=DEV, dtype=F32):
    """(y, z): y on the grid ``shape``, z on its coarse grid."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn(shape, generator=g, dtype=dtype, device=device)
    z = torch.randn(st.coarse_shape(shape), generator=g, dtype=dtype, device=device)
    return y, z


def _call(fn, y, z, out):
    """fn(y, z, out=...) with ``out`` one of :data:`OUTS`; (result, the
    buffer it must be, y's value before the call)."""
    y0 = y.clone()
    buf = {"none": None, "separate": torch.empty_like(y), "y": y}[out]
    return fn(y, z, out=buf), buf, y0


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("shape", [(16, 16, 16), (17, 17, 17), (17, 20, 9)])
def test_twin_is_the_expression_it_replaces(shape, out):
    for fn in (pa.prolong_add_reference, pa.prolong_add):  # the wrapper runs the twin here
        y, z = _fields(shape, sum(shape))
        want = y + st.prolong(z, shape)
        got, buf, y0 = _call(fn, y, z, out)
        assert torch.equal(got, want)
        assert buf is None or got is buf
        if out != "y":
            assert torch.equal(y, y0)


def _takes_cases():
    y, z = _fields((6, 7, 8), 1)
    y2 = torch.zeros(6, 7)
    return {
        "grid": ((y, z, (6, 7, 8)), True),
        "out": ((y, z, (6, 7, 8), torch.empty_like(y)), True),
        "out-y": ((y, z, (6, 7, 8), y), True),
        "2d": ((y2, torch.zeros(3, 4), (6, 7)), False),
        "float64": ((y.double(), z.double(), (6, 7, 8)), False),
        "z-float64": ((y, z.double(), (6, 7, 8)), False),
        "chain-dims": ((y[..., None].expand(6, 7, 8, 3), z[..., None].expand(3, 4, 4, 3), (6, 7, 8)), False),
        "another-grid": ((y, z, (6, 7, 9)), False),
        "wrong-coarse": ((y, z[:, :, :-1], (6, 7, 8)), False),
        "out-strided": ((y, z, (6, 7, 8), torch.empty(8, 7, 6).transpose(0, 2)), False),
        "out-float64": ((y, z, (6, 7, 8), torch.empty_like(y, dtype=torch.float64)), False),
        "out-shape": ((y, z, (6, 7, 8), torch.empty(6, 7, 9)), False),
    }


@pytest.mark.parametrize("case", ["grid", "out", "out-y", "2d", "float64", "z-float64", "chain-dims",
                                  "another-grid", "wrong-coarse", "out-strided", "out-float64",
                                  "out-shape"])
def test_takes(case):
    args, want = _takes_cases()[case]
    assert pa.takes(*args) == want


@pytest.mark.parametrize("case", ["3d", "odd", "float64", "2d", "chain-dims"])
def test_transfer_on_the_cpu_is_the_plain_expression(case):
    shape = {"3d": (8, 8, 8), "odd": (9, 6, 7), "float64": (8, 8, 8), "2d": (9, 10),
             "chain-dims": (8, 6, 4)}[case]
    dtype = torch.float64 if case == "float64" else F32
    tr = GeometricTransfer(fine_shape=shape)
    assert tr.impl == "kernel"
    y, z = _fields(shape, 5, dtype=dtype)
    if case == "chain-dims":
        y, z = torch.stack([y, 2 * y], -1), torch.stack([z, -z], -1)
    kernels.reset_launch_counts()
    for out in OUTS:
        yy = y.clone()
        want = torch.add(yy, tr.prolong(z))
        got, buf, _ = _call(tr.prolong_add, yy, z, out)
        assert torch.equal(got, want) and (buf is None or got is buf)
    assert kernels.launch_counts()["prolong_add"] == 0


def test_samplers_and_lax_variant():
    smp = MGMCSampler.create(gmrf_3d(16, device=DEV), n_pre=2, n_post=2, coarsest_size=16)
    assert [t.impl for t in smp.transfers] == ["kernel", "kernel"]
    plain = lax_variant(smp)
    assert all(isinstance(t, GeometricTransfer) and t.impl == "torch" for t in plain.transfers)
    assert [t.fine_shape for t in plain.transfers] == [t.fine_shape for t in smp.transfers]
    agg = MGMCSampler.create(gmrf_3d(16, device=DEV), n_pre=2, n_post=2, coarsest_size=16,
                             coarsening="aggregate")
    assert lax_variant(agg).transfers == agg.transfers
    assert all(isinstance(t, AggregateTransfer) for t in agg.transfers)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


# the 256^3 V(2,2) step's five fine shapes, odd and mixed extents, odd outer
# extents under a last extent of a multiple of 4, and a pointer off 16 bytes
CARD_SHAPES = ["256", "128", "64", "32", "16", "17", "17x20x9", "9x13x20", "misaligned"]


def _card_fields(case, dev):
    if case == "misaligned":  # y and z one float past an allocation's start
        shape = (16, 12, 20)
        y0, z0 = _fields(shape, 9, dev)
        y = torch.empty(y0.numel() + 1, device=dev)[1:].view(shape).copy_(y0)
        z = torch.empty(z0.numel() + 1, device=dev)[1:].view(z0.shape).copy_(z0)
        return y, z
    shape = tuple(int(s) for s in case.split("x")) if "x" in case else (int(case),) * 3
    return _fields(shape, len(case), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("case", CARD_SHAPES)
def test_kernel_is_its_twin_bit_for_bit(dev, case, out):
    y, z = _card_fields(case, dev)
    want = pa.prolong_add_reference(y, z)
    kernels.reset_launch_counts()
    got, buf, y0 = _call(pa.prolong_add, y, z, out)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["prolong_add"] == 1
    assert torch.equal(got, want) and (buf is None or got is buf)
    if out != "y":
        assert torch.equal(y, y0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16, 16), (17, 20, 9)])
def test_kernel_on_subnormal_and_large_values(dev, shape):
    """The rules that 0.5 (a + b) and 0.5 a + 0.5 a tell apart: subnormal
    coarse values (whose halves round) and values near the float32 range."""
    y, z = _fields(shape, 4, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    scale = torch.tensor([1.0, 1e-39, 1.4e-45, 1e38], device=dev)
    z = z * scale[torch.randint(0, 4, z.shape, generator=g, device=dev)]
    # y = 0 at half the points, so the interpolated bits show in the sum
    y = torch.where(torch.rand(y.shape, generator=g, device=dev) < 0.5, torch.zeros_like(y), y)
    want = pa.prolong_add_reference(y, z)
    got = pa.prolong_add(y, z)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_wrapper_refuses_bad_input(dev):
    y, z = _fields((16, 12, 20), 1, dev)
    with pytest.raises(TypeError):
        pa.prolong_add(y.double(), z.double())
    with pytest.raises(ValueError):
        pa.prolong_add(y.transpose(0, 2).contiguous().transpose(0, 2), z)
    with pytest.raises(ValueError):
        pa.prolong_add(y, z[:, :, :-1])
    with pytest.raises(ValueError):
        pa.prolong_add(y[0], z[0])
    with pytest.raises(ValueError):
        pa.prolong_add(y, z, out=torch.empty(16, 12, 21, device=dev))
    buf = torch.empty(y.numel() + z.numel(), device=dev)
    zz = buf[:z.numel()].view(z.shape).copy_(z)
    with pytest.raises(ValueError):  # out over z
        pa.prolong_add(y, zz, out=buf[:y.numel()].view(y.shape))
    with pytest.raises(ValueError):  # out over part of y
        yy = buf[:y.numel()].view(y.shape)
        pa.prolong_add(yy, z, out=buf[1:y.numel() + 1].view(y.shape))


@pytest.mark.cuda
def test_replayed_linear_chain_is_the_twins_chain(dev):
    from parmgmc_tpu_torch import replay

    smp = MGMCSampler.create(gmrf_3d(32, device=dev), n_pre=2, n_post=2)
    assert [o.grid_shape[0] for o in smp.ops] == [32, 16, 8]
    kernels.reset_launch_counts()
    st0 = init_chain(smp, 2**35 + 3)
    sa, qa = sample_chain(smp, st0, None, 6, extract=torch.mean)
    counts = kernels.launch_counts()
    assert counts["prolong_add"] == 6 * 2 and counts["chain_step_graph"] == 5
    with mock.patch.object(replay, "graphs_for", lambda *a: None), \
            mock.patch.object(pa, "prolong_add", pa.prolong_add_reference):
        kernels.reset_launch_counts()
        sb, qb = sample_chain(smp, st0, None, 6, extract=torch.mean)
        assert kernels.launch_counts()["prolong_add"] == 0
    assert sa.key == sb.key and torch.equal(sa.x, sb.x) and torch.equal(qa, qb)
