"""The keyed Gibbs step and the general keyed MGMC cycle (CPU).

* With the noise switched off inside the test (the sweep wrappers run
  with ``with_noise=False``, the coarse draw is zero), the keyed V(2,2),
  symmetric V(1,1) and W(1,1) cycles and the keyed Gibbs step are the
  explicit-noise ``step_with_noise`` with zero noises: held against the
  port's and the JAX package's, float32 on both sides (1e-5 relative).
* Short keyed chains (the sweep twins on CPU tensors) against the exact
  moments of the dense A^{-1} on a 128-DOF grid.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.operators.stencil import StencilOperator as JaxStencilOperator
from parmgmc_tpu.operators.stencil import shifted_laplace_fd as jax_shifted_laplace_fd
from parmgmc_tpu.samplers.gibbs import GibbsSampler as JaxGibbsSampler
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu_torch import convert, keys
from parmgmc_tpu_torch.chain import init_chain, sample_moments
from parmgmc_tpu_torch.kernels import rb_gibbs
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.samplers import gibbs
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

# the entry points default to the card; these tests run on the host
DEV = "cpu"
F32 = torch.float32
CYCLES = {
    "V22": dict(n_pre=2, n_post=2),
    "V11sym": dict(n_pre=1, n_post=1, sweep="symmetric", omega=1.2),
    "W11": dict(n_pre=1, n_post=1, gamma=2),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def noise_off(monkeypatch):
    """Run the keyed paths with every draw switched off."""
    for name in ("fused_rb_gibbs_sweep_fd", "fused_rb_gibbs_sweep"):
        monkeypatch.setattr(gibbs, name, functools.partial(getattr(rb_gibbs, name), with_noise=False))

    def zero_coarse_step(self, key, x, b, aux=None):
        key, _ = keys.split(key)
        eta = torch.zeros(self.n, dtype=self.dtype, device=self.L.device)
        return key, self.step_with_noise(x, b, [{"eta": eta}], aux)

    def zero_coarse_step_from(self, cur, x, b, aux=None):
        cur.generator(self.L.device)
        eta = torch.zeros(self.n, dtype=self.dtype, device=self.L.device)
        return self.step_with_noise(x, b, [{"eta": eta}], aux)

    monkeypatch.setattr(CholeskySampler, "step", zero_coarse_step)
    monkeypatch.setattr(CholeskySampler, "step_from", zero_coarse_step_from)


def _zeros(shapes):
    if isinstance(shapes, tuple):
        return np.zeros(shapes, np.float32)
    if isinstance(shapes, dict):
        return {k: _zeros(v) for k, v in shapes.items()}
    return [_zeros(v) for v in shapes]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("cycle", list(CYCLES))
@pytest.mark.parametrize("with_b", [False, True])
def test_keyed_cycle_without_noise_is_the_explicit_cycle(noise_off, cycle, with_b):
    kw = CYCLES[cycle]
    jsmp = JaxMGMCSampler.create(
        jax_shifted_laplace_fd((8, 8, 16), 1.3, dtype=jnp.float32), coarsest_size=16,
        coarsening="aggregate", impl="lax", **kw,
    )
    ops = [
        convert.stencil_operator(o.offsets, [np.asarray(c) for c in o.coeffs], np.asarray(o.diag), DEV)
        for o in jsmp.ops
    ]
    smp = convert.mgmc_sampler(ops, np.asarray(jsmp.coarse.L), np.asarray(jsmp.coarse.Li),
                               device=DEV, **kw)
    assert smp.n_levels == 3 and not smp.deferred_eligible()
    assert all(s.has_kernel and s.fd_params is not None for s in smp.smoothers)
    rs = np.random.RandomState(8)
    x = rs.randn(8, 8, 16).astype(np.float32)
    b = rs.randn(8, 8, 16).astype(np.float32) if with_b else None
    tb = None if b is None else torch.from_numpy(b)
    zeros = _zeros(smp.noise_shapes())
    _, got = smp.step(17, torch.from_numpy(x), tb)
    want_port = smp.step_with_noise(torch.from_numpy(x), tb, convert.tree(zeros, DEV))
    want_jax = jsmp.step_with_noise(
        jnp.asarray(x), None if b is None else jnp.asarray(b), jax.tree_util.tree_map(jnp.asarray, zeros)
    )
    assert got.dtype == F32
    assert _rel(got, want_port) < 1e-5
    assert _rel(got, want_jax) < 1e-5


def _field_operator(shape, kappa):
    """A 3D star stencil with scalar off-diagonals and a non-FD diagonal:
    the FD diagonal times a smooth field in [1, 2] (a variable-kappa
    GMRF), so the keyed step streams the diagonal (kernel #6)."""
    fd = shifted_laplace_fd(shape, kappa, device=DEV)
    i, j, k = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    field = 1.5 + 0.5 * np.sin(0.9 * i + 0.4 * j) * np.cos(0.3 * k)
    diag = fd.diag.numpy() * field.astype(np.float32)
    return convert.stencil_operator(fd.offsets, [c.numpy() for c in fd.coeffs], diag, DEV)


@pytest.mark.parametrize("sweep", ["forward", "symmetric"])
@pytest.mark.parametrize("mode", ["fd", "streamed"])
def test_keyed_gibbs_without_noise_is_the_explicit_step(noise_off, mode, sweep):
    shape = (6, 8, 10)
    op = shifted_laplace_fd(shape, 2.0, device=DEV) if mode == "fd" else _field_operator(shape, 2.0)
    smp = gibbs.GibbsSampler.create(op, omega=1.3, sweep=sweep)
    assert smp.has_kernel and (smp.fd_params is not None) == (mode == "fd")
    jop = _jax_operator(op)
    jsmp = JaxGibbsSampler.create(jop, omega=1.3, sweep=sweep, impl="lax")
    rs = np.random.RandomState(9)
    x, b = rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)
    zeros = _zeros(smp.noise_shapes())
    _, got = smp.step(3, torch.from_numpy(x), torch.from_numpy(b))
    want = jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(b), jax.tree_util.tree_map(jnp.asarray, zeros))
    assert _rel(got, want) < 1e-5
    assert _rel(got, smp.step_with_noise(torch.from_numpy(x), torch.from_numpy(b),
                                         convert.tree(zeros, DEV))) < 1e-5


def _jax_operator(op):
    return JaxStencilOperator(
        offsets=op.offsets,
        coeffs=tuple(jnp.asarray(c.numpy()) for c in op.coeffs),
        diag=jnp.asarray(op.diag.numpy()),
    )


def _exact_moments(op, b):
    A = op.to_dense().double()
    cov = torch.linalg.inv(A)
    mu = (cov @ b.double().reshape(-1)).reshape(op.grid_shape)
    return mu, torch.diagonal(cov).reshape(op.grid_shape)


@pytest.mark.parametrize("case", ["gibbs_fd", "gibbs_streamed", "mgmc_v22"])
def test_keyed_chain_moments(case):
    shape = (4, 4, 8)  # 128 DOF
    if case == "mgmc_v22":
        op = shifted_laplace_fd(shape, 1.0, device=DEV)
        smp = MGMCSampler.create(op, n_pre=2, n_post=2, coarsest_size=16, coarsening="aggregate")
        assert [o.grid_shape for o in smp.ops] == [(4, 4, 8), (2, 2, 4)]
        n, burnin = 1500, 20
    else:
        op = shifted_laplace_fd(shape, 3.0, device=DEV) if case == "gibbs_fd" else _field_operator(shape, 3.0)
        smp = gibbs.GibbsSampler.create(op, sweep="symmetric")
        assert smp.has_kernel and (smp.fd_params is None) == (case == "gibbs_streamed")
        n, burnin = 2500, 50
    b = torch.full(shape, 5.0)
    _, mean, var = sample_moments(smp, init_chain(smp, 1), b, n, burnin=burnin)
    mu, vex = _exact_moments(op, b)
    z = (mean.double() - mu).abs() / torch.sqrt(vex / n)
    rvar = (var.double() - vex).abs() / vex
    assert z.max() < 10.0 and z.mean() < 2.5, (z.max(), z.mean())
    assert rvar.max() < 0.2, rvar.max()
