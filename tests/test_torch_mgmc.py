"""The port's MGMC sampler against the JAX one, and its own invariants (CPU).

* explicit-noise ``step_with_noise`` against JAX at float64 on the same
  numpy noises, operators and Cholesky factors (1e-12);
* the exact invariance identity through ``torch.func.jacfwd`` (< 1e-10);
* the keyed kernel chain (the twins, on CPU tensors): deferred chain
  bitwise equal to the plain chain, moments and tau sane on a tiny grid,
  and out-of-slice configurations refused;
* the default coarsening is the JAX package's ("linear"): where JAX builds
  its linear hierarchy the port builds the same one, never the aggregate
  hierarchy in its place; odd extents run the general keyed cycle.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.models.problems import gmrf_2d as jax_gmrf_2d
from parmgmc_tpu.models.problems import gmrf_3d as jax_gmrf_3d
from parmgmc_tpu.operators.stencil import shifted_laplace_fd as jax_shifted_laplace_fd
from parmgmc_tpu.operators.transfer import GeometricTransfer as JaxGeometricTransfer
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu_torch import convert
from parmgmc_tpu_torch.chain import (
    ExplicitNoise,
    init_chain,
    sample_chain,
    sample_chain_deferred,
    sample_moments,
)
from parmgmc_tpu_torch.diagnostics.iact import iact
from parmgmc_tpu_torch.models.problems import gmrf_2d, gmrf_3d
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.operators.transfer import AggregateTransfer, GeometricTransfer
from parmgmc_tpu_torch.samplers import gibbs, mgmc
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
from parmgmc_tpu_torch.testing import invariance_error

F64 = torch.float64
# the entry points default to the card; these tests run on the host
DEV = "cpu"
_MAIN = dict(n_pre=1, n_post=0, sweep="forward", omega=1.0, gamma=1)
_GENERAL = dict(n_pre=1, n_post=1, sweep="symmetric", omega=1.2, gamma=2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _numpy_noises(shapes, rs):
    if isinstance(shapes, tuple):
        return rs.randn(*shapes)
    if isinstance(shapes, dict):
        return {k: _numpy_noises(v, rs) for k, v in shapes.items()}
    return [_numpy_noises(v, rs) for v in shapes]


@pytest.mark.parametrize("cfg", ["main", "general"])
@pytest.mark.parametrize("with_b", [False, True])
def test_step_with_noise_matches_jax(cfg, with_b):
    kw = _MAIN if cfg == "main" else _GENERAL
    jsmp = JaxMGMCSampler.create(
        jax_gmrf_3d(8, 1.0, jnp.float64), coarsest_size=16, coarsening="aggregate",
        impl="lax", **kw,
    )
    ops = [
        convert.stencil_operator(o.offsets, [np.asarray(c) for c in o.coeffs], np.asarray(o.diag),
                                 device=DEV)
        for o in jsmp.ops
    ]
    smp = convert.mgmc_sampler(ops, np.asarray(jsmp.coarse.L), np.asarray(jsmp.coarse.Li), device=DEV,
                              **kw)
    assert smp.n_levels == jsmp.n_levels == 2
    assert smp.noise_shapes() == jsmp.noise_shapes()
    rs = np.random.RandomState(5)
    x = rs.randn(8, 8, 8)
    b = rs.randn(8, 8, 8) if with_b else None
    noises = _numpy_noises(smp.noise_shapes(), rs)
    got = smp.step_with_noise(torch.from_numpy(x), None if b is None else torch.from_numpy(b),
                              convert.tree(noises, DEV))
    want = np.asarray(jsmp.step_with_noise(
        jnp.asarray(x), None if b is None else jnp.asarray(b), jax.tree_util.tree_map(jnp.asarray, noises)))
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("cfg", ["main", "general"])
def test_invariance(cfg):
    op = gmrf_3d(8, 1.0, F64, device=DEV)
    smp = MGMCSampler.create(op, coarsest_size=16, coarsening="aggregate", **(_MAIN if cfg == "main" else _GENERAL))
    b = torch.from_numpy(np.random.RandomState(6).randn(8, 8, 8))
    for rhs in (None, b):
        mean_err, cov_err = invariance_error(smp, op, rhs)
        assert mean_err < 1e-10 and cov_err < 1e-10, (rhs is None, mean_err, cov_err)


def _tiny_sampler():
    # (8, 8, 16) -> (4, 4, 8) -> (2, 2, 4): level 0 on the chain kernel,
    # level 1 on the tail kernel, a 16-DOF Cholesky coarsest level
    op = shifted_laplace_fd((8, 8, 16), 1.0, device=DEV)
    smp = MGMCSampler.create(op, n_pre=1, n_post=0, coarsest_size=16, coarsening="aggregate")
    assert [o.grid_shape for o in smp.ops] == [(8, 8, 16), (4, 4, 8), (2, 2, 4)]
    return op, smp


def test_deferred_chain_is_bitwise_the_plain_chain():
    op, smp = _tiny_sampler()
    b = torch.from_numpy(np.random.RandomState(7).randn(*op.grid_shape).astype(np.float32))
    for rhs in (None, b):
        st = init_chain(smp, 11)
        sa, qa = sample_chain(smp, st, rhs, 8, extract=torch.mean)
        sb, qb = sample_chain_deferred(smp, st, rhs, 8)
        assert torch.equal(sa.x, sb.x) and sa.key == sb.key
        assert (qa - qb).abs().max() <= 1e-5 * qa.abs().max()
    # fmg_init draws a finite start of the right shape on the same kernels
    key, x0 = smp.fmg_init(3, b)
    assert x0.shape == op.grid_shape and bool(torch.isfinite(x0).all())


def test_keyed_chain_moments_and_tau():
    op, smp = _tiny_sampler()
    b = torch.full(op.grid_shape, 5.0)
    n = 3000
    _, mean, var = sample_moments(smp, init_chain(smp, 1), b, n, burnin=50)
    A = op.to_dense().double()
    cov = torch.linalg.inv(A)
    mu = (cov @ b.double().reshape(-1)).reshape(op.grid_shape)
    vex = torch.diagonal(cov).reshape(op.grid_shape)
    z = (mean.double() - mu).abs() / torch.sqrt(vex / n)
    rvar = (var.double() - vex).abs() / vex
    assert z.max() < 10.0 and z.mean() < 2.5, (z.max(), z.mean())
    assert rvar.max() < 0.2, rvar.max()
    _, q = sample_chain_deferred(smp, init_chain(smp, 2), None, 1000)
    tau, _ = iact(q)
    assert np.isfinite(tau) and 0.2 < tau < 20.0
    # the explicit-noise chain of the same sampler targets the same law
    _, mean_p, _ = sample_moments(ExplicitNoise(smp), init_chain(smp, 3), b, 500)
    zp = (mean_p.double() - mu).abs() / torch.sqrt(vex / 500)
    assert zp.mean() < 2.5


def test_keyed_path_refuses_out_of_slice_configs():
    op = shifted_laplace_fd((8, 8, 16), 1.0, device=DEV)
    x = torch.zeros(op.grid_shape)
    # cycles other than V(1,0) run the general keyed cycle; the deferred
    # chain stays the V(1,0) chain kernels' alone
    for kw in (dict(n_post=1), dict(n_post=0, gamma=2), dict(n_post=0, sweep="symmetric")):
        smp = MGMCSampler.create(op, coarsest_size=16, coarsening="aggregate", **kw)
        assert not smp.deferred_eligible()
        _, x1 = smp.step(0, x, None)
        assert x1.shape == op.grid_shape and bool(torch.isfinite(x1).all())
        _, x0 = smp.fmg_init(1, None)  # fmg_init runs the general cycle too
        assert x0.shape == op.grid_shape and bool(torch.isfinite(x0).all())
        with pytest.raises(NotImplementedError):
            smp.step_deferred(0, x, smp.deferred_init(x.dtype), None)
    # float64 levels have no kernel: the smoothers take explicit-noise steps
    smp64 = MGMCSampler.create(shifted_laplace_fd((8, 8, 16), 1.0, F64, device=DEV), n_post=0,
                                coarsest_size=16, coarsening="aggregate")
    assert not smp64.deferred_eligible() and not smp64.smoothers[0].has_kernel
    _, x64 = smp64.step(0, x.double(), None)
    assert x64.dtype == F64 and bool(torch.isfinite(x64).all())
    # grids with an odd extent run the general keyed cycle, in 2D as in 3D:
    # the aggregate hierarchy coarsens them by the comb-probed Galerkin
    # product (JAX's levels), and a keyed step runs levels built by hand
    # with one; neither admits the chain kernels
    op2d = shifted_laplace_fd((8, 14), 1.0, device=DEV)
    smp = MGMCSampler.create(op2d, coarsest_size=4, coarsening="aggregate")
    jsmp = JaxMGMCSampler.create(jax_shifted_laplace_fd((8, 14), 1.0, dtype=jnp.float32), coarsest_size=4,
                                 coarsening="aggregate")
    assert [o.grid_shape for o in smp.ops] == [tuple(o.grid_shape) for o in jsmp.ops] == [(8, 14), (4, 7), (2, 4)]
    for o, jo in zip(smp.ops, jsmp.ops):
        assert o.offsets == jo.offsets
        want = np.asarray(jo.to_dense())
        assert np.abs(o.to_dense().numpy() - want).max() <= 1e-6 * np.abs(want).max()
    _, x2 = smp.step(0, torch.zeros(8, 14), None)
    assert not smp.deferred_eligible() and bool(torch.isfinite(x2).all())
    ops = [shifted_laplace_fd(s, 1.0, device=DEV) for s in ((6, 10), (3, 5), (2, 3))]
    chol = CholeskySampler.create(ops[-1])
    smp2d = convert.mgmc_sampler(ops, chol.L.numpy(), chol.Li.numpy(), n_post=0, device=DEV)
    _, x2 = smp2d.step(0, torch.zeros(6, 10), None)
    assert not smp2d.deferred_eligible() and x2.shape == (6, 10) and bool(torch.isfinite(x2).all())


_V22 = dict(n_pre=2, n_post=2, coarsening="aggregate")


def test_keyed_2d_cycle_without_noise_is_the_explicit_cycle(monkeypatch):
    """gmrf_2d(64) V(2,2) (64^2, 32^2, 16^2): the keyed step runs the
    general keyed cycle, its smoothers' explicit-noise steps; with their
    draws and the coarse draw switched off it is JAX's step_with_noise
    with zero noises (float32, 1e-5)."""

    def zeros(key, shapes, dtype, device):
        if isinstance(shapes, tuple):
            return torch.zeros(shapes, dtype=dtype, device=device)
        if isinstance(shapes, dict):
            return {k: zeros(key, v, dtype, device) for k, v in shapes.items()}
        return [zeros(key, v, dtype, device) for v in shapes]

    monkeypatch.setattr(gibbs, "_draw", zeros)
    monkeypatch.setattr(CholeskySampler, "step", lambda self, key, x, b, aux=None: (
        key, self.step_with_noise(x, b, [{"eta": torch.zeros(self.n, dtype=self.dtype)}], aux)))
    monkeypatch.setattr(CholeskySampler, "step_from", lambda self, cur, x, b, aux=None: (
        cur.generator(self.L.device),
        self.step_with_noise(x, b, [{"eta": torch.zeros(self.n, dtype=self.dtype)}], aux))[1])
    jsmp = JaxMGMCSampler.create(jax_gmrf_2d(64, dtype=jnp.float32), impl="lax", **_V22)
    ops = [convert.stencil_operator(o.offsets, [np.asarray(c) for c in o.coeffs], np.asarray(o.diag), DEV)
           for o in jsmp.ops]
    smp = convert.mgmc_sampler(ops, np.asarray(jsmp.coarse.L), np.asarray(jsmp.coarse.Li), device=DEV,
                               n_pre=2, n_post=2)
    assert [o.grid_shape for o in smp.ops] == [(64, 64), (32, 32), (16, 16)]
    assert not smp.deferred_eligible()  # the general keyed cycle
    rs = np.random.RandomState(12)
    x, b = rs.randn(64, 64).astype(np.float32), rs.randn(64, 64).astype(np.float32)
    zero_noises = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s, jnp.float32), jsmp.noise_shapes(), is_leaf=lambda s: isinstance(s, tuple))
    for tb in (None, torch.from_numpy(b)):
        _, got = smp.step(3, torch.from_numpy(x), tb)
        want = np.asarray(jsmp.step_with_noise(jnp.asarray(x), None if tb is None else jnp.asarray(b),
                                               zero_noises))
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_keyed_2d_chain_moments():
    """gmrf_2d(64) V(2,2) keyed chain, b = 1: A 1 = kappa^2 1, so the mean
    of each sample is exactly N(1/kappa^2, 1/(kappa^2 N))."""
    smp = MGMCSampler.create(gmrf_2d(64, device=DEV), **_V22)
    b = torch.ones(64, 64)
    n, npts = 1000, 64 * 64
    _, q = sample_chain(smp, init_chain(smp, 5, b.clone()), b, n, extract=torch.mean)
    q = q.double()
    tau, _ = iact(q)
    var_ratio = q.var().item() * npts
    zmean = (q.mean().item() - 1.0) * np.sqrt(npts * n / max(tau, 1.0))
    assert 0.8 < var_ratio < 1.25 and abs(zmean) < 5.0, (var_ratio, zmean, tau)


def test_default_coarsening_is_the_jax_default():
    """create(op) with every default builds the linear hierarchy in both
    packages: GeometricTransfer at every level and the comb-probed
    Galerkin operators (JAX's, to float32 rounding) -- never the
    aggregate hierarchy in its place.  One level needs no transfer and
    builds in both packages."""
    jsmp = JaxMGMCSampler.create(jax_gmrf_3d(16, kappa=1.0))
    assert jsmp.n_levels > 1
    assert all(isinstance(t, JaxGeometricTransfer) for t in jsmp.transfers)
    op = gmrf_3d(16, kappa=1.0, device=DEV)
    with mock.patch.object(mgmc, "AggregateTransfer", side_effect=AssertionError("aggregate built")):
        smp = MGMCSampler.create(op)
        ops, transfers = mgmc.build_hierarchy(op)
        one = MGMCSampler.create(op, n_levels=1)
    assert all(isinstance(t, GeometricTransfer) for t in (*smp.transfers, *transfers))
    assert [o.grid_shape for o in smp.ops] == [o.grid_shape for o in ops] == [tuple(o.grid_shape) for o in jsmp.ops]
    for o, jo in zip(smp.ops, jsmp.ops):
        assert o.offsets == jo.offsets
        want = np.asarray(jo.to_dense())
        assert np.abs(o.to_dense().numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert one.n_levels == JaxMGMCSampler.create(jax_gmrf_3d(16, kappa=1.0), n_levels=1).n_levels == 1
    agg = MGMCSampler.create(op, coarsening="aggregate")
    assert [o.grid_shape for o in agg.ops] == [tuple(o.grid_shape) for o in jsmp.ops]
    assert all(isinstance(t, AggregateTransfer) for t in agg.transfers)
