"""The port's operators, transfers, hierarchy, SOR/Gibbs and Cholesky
samplers against the JAX package (CPU, float64).

Inputs are made with numpy from a seed; operators and factors cross over
through ``parmgmc_tpu_torch.convert``.  Deterministic maps must agree to
1e-12 (float64 rounding), transfers exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.models.problems import gmrf_2d as jax_gmrf_2d
from parmgmc_tpu.models.problems import gmrf_3d as jax_gmrf_3d
from parmgmc_tpu.operators.stencil import fd_stencil as jax_fd_stencil
from parmgmc_tpu.operators.transfer import AggregateTransfer as JaxAggregateTransfer
from parmgmc_tpu.samplers.cholesky import CholeskySampler as JaxCholeskySampler
from parmgmc_tpu.samplers.gibbs import GibbsSampler as JaxGibbsSampler
from parmgmc_tpu.samplers.mgmc import build_hierarchy as jax_build_hierarchy
from parmgmc_tpu.samplers.sor import sor_sweep as jax_sor_sweep
from parmgmc_tpu_torch import convert
from parmgmc_tpu_torch.models.problems import gmrf_2d, gmrf_3d
from parmgmc_tpu_torch.operators.stencil import (
    FDStencilOperator,
    coarse_shape,
    detect_fd_params,
    fd_stencil,
    shifted_laplace_fd,
)
from parmgmc_tpu_torch.operators.transfer import AggregateTransfer
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
from parmgmc_tpu_torch.samplers.mgmc import build_hierarchy
from parmgmc_tpu_torch.samplers.sor import color_masks, sor_sweep

F64 = torch.float64
# the entry points default to the card; these tests run on the host
DEV = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_arrays(op):
    return op.offsets, [np.asarray(c) for c in op.coeffs], np.asarray(op.diag)


@pytest.mark.parametrize("case", ["gmrf_3d", "gmrf_2d", "lazy", "convert"])
def test_apply_and_to_dense_match_jax(case):
    rs = np.random.RandomState(0)
    if case == "gmrf_3d":
        jop, op = jax_gmrf_3d(6, 1.3, jnp.float64), gmrf_3d(6, 1.3, F64, device=DEV)
    elif case == "gmrf_2d":
        jop, op = jax_gmrf_2d(7, 0.4, jnp.float64), gmrf_2d(7, 0.4, F64, device=DEV)
    elif case == "lazy":
        jop = jax_fd_stencil((4, 6, 8), 2.5, 31.0, jnp.float64, lazy=True)
        op = convert.fd_operator(*(float(v) for v in jop.fd_params()), jop.grid_shape, F64, device=DEV, lazy=True)
        assert isinstance(op, FDStencilOperator) and op.fd_params() == (2.5, 31.0)
    else:
        jop = jax_gmrf_3d(5, 2.0, jnp.float64)
        op = convert.stencil_operator(*_jax_arrays(jop), device=DEV)
    x = rs.randn(*jop.grid_shape)
    y, yj = op.apply(_t(x)).numpy(), np.asarray(jop.apply(jnp.asarray(x)))
    assert np.abs(y - yj).max() <= 1e-12 * np.abs(yj).max()
    A, Aj = op.to_dense().numpy(), np.asarray(jop.to_dense())
    assert np.abs(A - Aj).max() <= 1e-12 * np.abs(Aj).max()
    assert np.abs(A - A.T).max() == 0.0


def test_fd_detection_and_coarse_shape():
    op = shifted_laplace_fd((6, 4, 8), 1.5, F64, device=DEV)
    assert detect_fd_params(op) == pytest.approx((2.25, 25.0), rel=1e-15)
    lazy = fd_stencil((6, 4, 8), 2.25, 25.0, F64, device=DEV, lazy=True)
    assert detect_fd_params(lazy) == (2.25, 25.0)
    assert torch.equal(lazy.diag, op.diag)
    # a non-FD diagonal is not detected
    bent = convert.stencil_operator(op.offsets, [c.numpy() for c in op.coeffs], op.diag.numpy() * 1.1,
                                   device=DEV)
    assert detect_fd_params(bent) is None
    assert coarse_shape((7, 8, 1)) == (4, 4, 1)


@pytest.mark.parametrize("shape", [(6, 4, 8), (5, 6, 7), (4, 3)])
def test_aggregate_transfer_matches_jax_exactly(shape):
    rs = np.random.RandomState(1)
    tr, jtr = AggregateTransfer(shape), JaxAggregateTransfer(fine_shape=shape)
    xf = rs.randn(*shape)
    xc = rs.randn(*coarse_shape(shape))
    assert np.array_equal(tr.restrict(_t(xf)).numpy(), np.asarray(jtr.restrict(jnp.asarray(xf))))
    assert np.array_equal(tr.prolong(_t(xc)).numpy(), np.asarray(jtr.prolong(jnp.asarray(xc))))
    y = rs.randn(*shape)
    assert torch.equal(tr.prolong_add(_t(y), _t(xc)), _t(y) + tr.prolong(_t(xc)))


def test_hierarchy_matches_galerkin_and_jax():
    op = gmrf_3d(8, 1.1, F64, device=DEV)
    ops, transfers = build_hierarchy(op, coarsest_size=16, coarsening="aggregate")
    jops, _ = jax_build_hierarchy(jax_gmrf_3d(8, 1.1, jnp.float64), coarsest_size=16,
                                  coarsening="aggregate")
    assert [o.grid_shape for o in ops] == [tuple(o.grid_shape) for o in jops] == [(8,) * 3, (4,) * 3]
    for l, tr in enumerate(transfers):
        nf, nc = ops[l].n, ops[l + 1].n
        P = tr.prolong(torch.eye(nc, dtype=F64).T.reshape(*ops[l + 1].grid_shape, nc)).reshape(nf, nc)
        galerkin = P.T @ ops[l].to_dense() @ P
        Ac = ops[l + 1].to_dense()
        assert (Ac - galerkin).abs().max() <= 1e-12 * galerkin.abs().max()
        Aj = np.asarray(jops[l + 1].to_dense())
        assert np.abs(Ac.numpy() - Aj).max() <= 1e-12 * np.abs(Aj).max()
    # the linear hierarchy and odd aggregate extents build JAX's levels
    for shape, kw in (((8,) * 3, dict(coarsest_size=16, coarsening="linear")),
                      ((7,) * 3, dict(coarsest_size=16, coarsening="aggregate"))):
        ops, _ = build_hierarchy(gmrf_3d(shape[0], 1.1, F64, device=DEV), **kw)
        jops, _ = jax_build_hierarchy(jax_gmrf_3d(shape[0], 1.1, jnp.float64), **kw)
        assert [o.grid_shape for o in ops] == [tuple(o.grid_shape) for o in jops] == [shape, (4,) * 3]
        for o, jo in zip(ops, jops):
            Aj = np.asarray(jo.to_dense())
            assert o.offsets == jo.offsets
            assert np.abs(o.to_dense().numpy() - Aj).max() <= 1e-12 * np.abs(Aj).max()


@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
def test_sor_and_gibbs_match_jax(sweep):
    rs = np.random.RandomState(2)
    jop = jax_gmrf_3d(6, 1.7, jnp.float64)
    op = convert.stencil_operator(*_jax_arrays(jop), device=DEV)
    x, b = rs.randn(6, 6, 6), rs.randn(6, 6, 6)
    got = sor_sweep(op, _t(b), _t(x), 1.3, sweep)
    want = np.asarray(jax_sor_sweep(jop, jnp.asarray(b), jnp.asarray(x), 1.3, sweep))
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()

    smp = GibbsSampler.create(op, omega=1.3, sweep=sweep)
    jsmp = JaxGibbsSampler.create(jop, omega=1.3, sweep=sweep, impl="lax")
    assert smp.fd_params == pytest.approx(tuple(float(v) for v in jsmp.fd_params), rel=1e-15)
    noises = [{"eta": rs.randn(6, 6, 6)} for _ in smp.noise_shapes()]
    got = smp.step_with_noise(_t(x), _t(b), convert.tree(noises, DEV))
    want = np.asarray(jsmp.step_with_noise(
        jnp.asarray(x), jnp.asarray(b), [{"eta": jnp.asarray(n["eta"])} for n in noises]))
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_cholesky_matches_jax():
    rs = np.random.RandomState(3)
    jop = jax_gmrf_3d(4, 2.0, jnp.float64)
    jc = JaxCholeskySampler.create(jop)
    c = convert.cholesky_sampler(np.asarray(jc.L), np.asarray(jc.Li), jop.grid_shape, DEV)
    assert c.Li is not None
    b, eta = rs.randn(4, 4, 4), rs.randn(64)
    got = c.step_with_noise(None, _t(b), [{"eta": _t(eta)}])
    want = np.asarray(jc.step_with_noise(None, jnp.asarray(b), [{"eta": jnp.asarray(eta)}]))
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    # the port's own factorisation gives the same sampler
    own = CholeskySampler.create(convert.stencil_operator(*_jax_arrays(jop), device=DEV))
    assert (own.L - c.L).abs().max() < 1e-12 * c.L.abs().max()
    # an explicit inverse that does not reproduce I is dropped (solve path)
    bad = convert.cholesky_sampler(np.asarray(jc.L), np.asarray(jc.Li) * 1.01, jop.grid_shape, DEV)
    assert bad.Li is None
    got2 = bad.step_with_noise(None, _t(b), [{"eta": _t(eta)}])
    assert (got2 - got).abs().max() <= 1e-12 * got.abs().max()


def test_entry_points_default_to_cuda():
    # no device argument means the card: a constructor that allocates
    # raises here (no CUDA in this torch), one that does not says cuda
    lazy = fd_stencil((8, 8, 16), 1.0, 49.0, lazy=True)
    assert lazy.device.type == "cuda"
    assert GibbsSampler.create(lazy).device.type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this checks the host's refusal; a card is present")
    for make in (
        lambda: gmrf_3d(4),
        lambda: gmrf_2d(4),
        lambda: shifted_laplace_fd((4, 4, 4), 1.0),
        lambda: fd_stencil((4, 4, 4), 1.0, 9.0),
        lambda: convert.tensor(np.zeros(3)),
        lambda: convert.stencil_operator(lazy.offsets, [np.float32(-1.0)] * 6, np.ones((2, 2, 2))),
        lambda: color_masks((4, 4), 2),
        lambda: lazy.diag,
    ):
        with pytest.raises((AssertionError, RuntimeError)):
            make()
