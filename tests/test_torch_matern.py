"""The structured Matérn façade, many chains and the plain route (CPU).

* ``MaternSampler`` on 17 x 17 in float64: the field's moments against the
  exact mean 0 and diag(A^{-1}); ``sample_chains``' shape, its chains
  equal to separate ``sample_chain`` calls under the JAX key layout, and
  its continuation across calls;
* ``chain.multi_chain`` against C separate ``sample_chain`` calls, bit for
  bit, on a sampler whose step runs the chain kernels' wrappers;
* the structured ``step_with_noise`` with a trailing chain dim (C = 3;
  MGMC, Gibbs) against JAX's step chain by chain with the same draws,
  float64, 1e-12, and the keyed plain step with trailing dims;
* a kernel sampler given trailing chain dims raises (naming
  ``lax_variant``) before any kernel runs; ``registry.lax_variant``
  turns every kernel route to plain torch (recursively, Woodbury's inner
  sampler too), runs no kernel wrapper, and draws as the explicit-noise
  route does;
* ex9's patch-smoothed MGMC built through ``build_sampler``: the step with
  explicit draws against JAX in float64, and the invariance identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.models.problems import squared_shifted_laplace_fd as jax_squared_fd
from parmgmc_tpu.operators import stencil as jst
from parmgmc_tpu.samplers.gibbs import GibbsSampler as JaxGibbsSampler
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu.samplers.registry import build_sampler as jax_build_sampler
from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.chain import ChainState, ExplicitNoise, init_chain, multi_chain, sample_chain
from parmgmc_tpu_torch.kernels import mg_sweep, mg_tail
from parmgmc_tpu_torch.models.matern import MaternSampler
from parmgmc_tpu_torch.models.obs import make_posterior_operator
from parmgmc_tpu_torch.models.problems import squared_shifted_laplace_fd
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.samplers import gibbs, patch_gibbs
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
from parmgmc_tpu_torch.samplers.patch_gibbs import PatchGibbsSampler
from parmgmc_tpu_torch.samplers.registry import build_sampler, lax_variant
from parmgmc_tpu_torch.samplers.woodbury import WoodburySampler
from parmgmc_tpu_torch.testing import invariance_error

# the entry points default to the card; these tests run on the host
DEV = "cpu"
F32, F64 = torch.float32, torch.float64
C = 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel wrapper a sampler step can reach raises if called."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran")

    for name in ("fused_rb_gibbs_sweep_fd", "fused_rb_gibbs_sweep"):
        monkeypatch.setattr(gibbs, name, refuse)
    monkeypatch.setattr(patch_gibbs, "fused_patch_sweep_sqfd", refuse)
    for name in ("fused_chain_down_fd", "fused_chain_down_2d", "fused_chain_down_2d_staged",
                 "fused_zero_gibbs_restrict_fd"):
        monkeypatch.setattr(mg_sweep, name, refuse)
    monkeypatch.setattr(mg_tail, "fused_tail_down", refuse)


def _v10(shape=(8, 8, 16)):
    """A float32 V(1,0) sampler whose keyed step runs #1 and #2's wrappers
    (their plain twins on CPU tensors)."""
    op = shifted_laplace_fd(shape, 1.0, device=DEV)
    smp = MGMCSampler.create(op, n_pre=1, n_post=0, coarsest_size=16, coarsening="aggregate")
    assert smp.deferred_eligible() and smp.has_kernel
    return smp


def _noises(shapes, rng, batch=()):
    leaves, treedef = jax.tree_util.tree_flatten(shapes, is_leaf=lambda s: isinstance(s, tuple))
    return jax.tree_util.tree_unflatten(treedef, [rng.standard_normal(tuple(s) + batch) for s in leaves])


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def test_matern_sampler_moments():
    """17 x 17, kappa 1, float64, two-level MGMC: the sample mean within
    5 standard errors of 0 at every point, the sample variance within
    15 % of diag(A^{-1}) (about 5 standard errors at 4000 draws)."""
    ms = MaternSampler((17, 17), kappa=1.0, dtype=F64, seed=3, device=DEV, n_levels=2)
    assert ms.op.device.type == "cpu" and ms.b.abs().max() == 0
    mean, var = ms.sample_mean_and_var(4000, burnin=100)
    Ainv = np.linalg.inv(ms.op.to_dense().numpy())
    dvar = np.diag(Ainv).reshape(17, 17)
    z = np.abs(mean.numpy()) / np.sqrt(2.0 * dvar / 4000)  # tau <= 2
    assert z.max() < 5.0, z.max()
    assert np.abs(var.numpy() / dvar - 1.0).max() < 0.15


def test_matern_sampler_qoi_and_chains():
    """``sample`` streams the QOI; ``sample_chains`` gives (C, n) traces,
    each chain the plain chain under the keys split(fold_in(key, C), C),
    and a second call continues the chains."""
    kw = dict(kappa=2.0, dtype=F64, seed=5, device=DEV, n_levels=2)
    ms = MaternSampler((9, 9), **kw)
    ms.set_qoi(torch.mean)
    q = ms.sample(20, burnin=5)
    assert q.shape == (20,) and torch.isfinite(q).all()
    a = ms.sample_chains(6, C)
    b = ms.sample_chains(6, C)
    assert a.shape == b.shape == (C, 6)
    whole = MaternSampler((9, 9), **kw)
    whole.set_qoi(torch.mean)
    whole.sample(20, burnin=5)  # the chains' keys fold the main chain's key
    both = whole.sample_chains(12, C)
    assert torch.equal(torch.cat([a, b], dim=1), both)
    for c, k in enumerate(keys.split(keys.fold_in(whole.state.key, C), C)):
        _, qc = sample_chain(whole.sampler, init_chain(whole.sampler, k), whole.b, 12, extract=torch.mean)
        assert torch.equal(qc, both[c])


def test_multi_chain_is_separate_chains_bit_for_bit():
    smp = _v10()
    ks = (11, 12, 13)
    rs = np.random.RandomState(2)
    x0 = torch.from_numpy(rs.randn(C, 8, 8, 16).astype(np.float32))
    run = multi_chain(lambda st: sample_chain(smp, st, None, 5, extract=torch.mean), C)
    st, q = run(ChainState(x=x0, key=ks))
    assert st.x.shape == (C, 8, 8, 16) and len(st.key) == C and q.shape == (C, 5)
    for c in range(C):
        st_c, q_c = sample_chain(smp, ChainState(x=x0[c], key=ks[c]), None, 5, extract=torch.mean)
        assert torch.equal(st.x[c], st_c.x) and st.key[c] == st_c.key and torch.equal(q[c], q_c)
    with pytest.raises(ValueError):
        run(ChainState(x=x0[:2], key=ks[:2]))


CASES = [  # (grid, sampler kind, options)
    ((9, 9), "mgmc", dict(n_levels=2)),
    ((6, 6, 8), "mgmc", dict(n_pre=2, n_post=2, coarsest_size=16, coarsening="aggregate")),
    ((9, 9), "gibbs", dict(sweep="symmetric")),
    ((6, 6, 8), "gibbs", dict(sweep="forward", omega=1.2)),
]


@pytest.mark.parametrize("shape,kind,kw", CASES)
def test_batched_step_with_noise_matches_jax(shape, kind, kw):
    """x with a trailing chain dim of 3 against JAX's step on each chain
    (its structured operators take one chain) with the same draws."""
    jop = jst.shifted_laplace_fd(shape, 1.3, dtype=jnp.float64)
    op = shifted_laplace_fd(shape, 1.3, dtype=F64, device=DEV)
    if kind == "mgmc":
        js, s = JaxMGMCSampler.create(jop, impl="lax", **kw), MGMCSampler.create(op, **kw)
    else:
        js, s = JaxGibbsSampler.create(jop, impl="lax", **kw), GibbsSampler.create(op, **kw)
    rng = np.random.default_rng(1)
    nz = _noises(js.noise_shapes(), rng, (C,))
    x, b = rng.standard_normal(shape + (C,)), rng.standard_normal(shape)
    want = np.stack([
        np.asarray(js.step_with_noise(jnp.asarray(x[..., c]), jnp.asarray(b),
                                      jax.tree_util.tree_map(lambda a: jnp.asarray(a[..., c]), nz)))
        for c in range(C)], axis=-1)
    got = s.step_with_noise(torch.from_numpy(x), torch.from_numpy(b), _torch_tree(nz)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # the keyed plain step takes the trailing dims, each chain its own draws
    _, y = s.step(7, torch.from_numpy(x), torch.from_numpy(b))
    assert y.shape == shape + (C,) and torch.isfinite(y).all()
    assert not torch.equal(y[..., 0], y[..., 1])


def test_kernel_sampler_refuses_trailing_chain_dims(no_kernels):
    op = shifted_laplace_fd((8, 8, 16), 1.0, device=DEV)
    xb = torch.zeros((8, 8, 16, C))
    for smp in (GibbsSampler.create(op), _v10(),
                MGMCSampler.create(op, n_pre=2, n_post=2, coarsest_size=16, coarsening="aggregate"),
                PatchGibbsSampler.create(squared_shifted_laplace_fd((8, 8, 16), 1.0, device=DEV))):
        assert smp.has_kernel
        with pytest.raises(ValueError, match="lax_variant"):
            smp.step(1, xb, None)
    v10 = _v10()
    with pytest.raises(ValueError, match="lax_variant"):
        v10.step_deferred(1, xb, v10.deferred_init(F32), None)


def test_lax_variant_runs_no_kernel(no_kernels):
    op = shifted_laplace_fd((8, 8, 16), 1.0, device=DEV)
    smp = lax_variant(_v10())
    assert all(s.impl == "torch" and not s.has_kernel for s in smp.smoothers)
    assert not smp.deferred_eligible() and not smp.has_kernel and smp.lrc_aux is None
    x = torch.from_numpy(np.random.RandomState(4).randn(8, 8, 16, C).astype(np.float32))
    _, y = smp.step(3, x, None)  # trailing dims: the explicit-noise step
    assert y.shape == x.shape and torch.isfinite(y).all()
    _, y0 = smp.step(3, x[..., 0], None)  # one chain: the general keyed cycle
    assert torch.isfinite(y0).all()
    g = lax_variant(GibbsSampler.create(op, sweep="symmetric"))
    assert g.route == "torch"
    k1, a = g.step(9, x, None)
    k2, b = ExplicitNoise(g).step(9, x, None)  # the same generator draws
    assert k1 == k2 and torch.equal(a, b)
    p = lax_variant(PatchGibbsSampler.create(squared_shifted_laplace_fd((8, 8, 16), 1.0, device=DEV)))
    assert p.impl == "torch" and not p.has_kernel
    _, yp = p.step(2, x[..., 0], None)
    assert torch.isfinite(yp).all()
    # recursion into Woodbury's inner sampler
    post, _ = make_posterior_operator(op, 0.05, np.array([[0.5, 0.5, 0.5]]), np.array([0.3]))
    wb = WoodburySampler.create(post, GibbsSampler.create(op))
    assert wb.sampler.impl == "kernel" and lax_variant(wb).sampler.impl == "torch"


@pytest.fixture(scope="module")
def ex9():
    """ex9's config (examples/ex9_squared_prior.py:35-44) on 9 x 9, kappa 2,
    float64, built by both packages' build_sampler."""
    cfg = {"type": "mgmc", "n_levels": 3, "smoother": {"type": "patch_gibbs"}, "n_pre": 1, "n_post": 1}
    jop = jax_squared_fd((9, 9), 2.0, dtype=jnp.float64)
    op = squared_shifted_laplace_fd((9, 9), 2.0, dtype=F64, device=DEV)
    return jax_build_sampler(jop, cfg), build_sampler(op, cfg), op


def test_ex9_step_with_noise_matches_jax(ex9):
    js, s, _ = ex9
    assert [tuple(o.grid_shape) for o in s.ops] == [tuple(o.grid_shape) for o in js.ops] == [
        (9, 9), (5, 5), (3, 3)]
    assert all(isinstance(sm, PatchGibbsSampler) for sm in s.smoothers)
    assert isinstance(s.coarse, CholeskySampler)
    rng = np.random.default_rng(9)
    nz = _noises(js.noise_shapes(), rng)
    x, b = rng.standard_normal((9, 9)), rng.standard_normal((9, 9))
    want = np.asarray(js.step_with_noise(jnp.asarray(x), jnp.asarray(b),
                                         jax.tree_util.tree_map(jnp.asarray, nz)))
    got = s.step_with_noise(torch.from_numpy(x), torch.from_numpy(b), _torch_tree(nz)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_ex9_invariance(ex9):
    _, s, op = ex9
    b = torch.from_numpy(np.random.RandomState(5).randn(9, 9))
    mean_err, cov_err = invariance_error(s, op, b)
    assert mean_err < 1e-10 and cov_err < 1e-10, (mean_err, cov_err)
