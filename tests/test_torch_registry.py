"""Natural-order Gibbs, the sampler registry and the README quick start
on the port, against the JAX package (CPU).

* ``natural_sweep`` (wavefronts) equals ``lexicographic_sweep`` (the
  sequential scan) on star and non-star stencils (a 9-point Galerkin
  level, a radius-2 squared operator), forward, backward and symmetric
  (float64, 1e-14); ``natural_sweep`` and
  ``NaturalGibbsSampler.step_with_noise`` against JAX's (1e-12);
* ``build_sampler`` against JAX's on the same config trees: the README
  posterior tree, the registry docstring's MGMC tree, an MGMC tree with
  natural-order smoothers, Woodbury trees and a patch-Gibbs tree, each
  ``step_with_noise`` on the same numpy noises (float64); the Cholesky
  modes (dense, sparse, auto), an unknown type and a registered one;
* the README quick start, ``MGMCSampler.create(gmrf_2d(64), n_pre=2,
  n_post=2)``: JAX's hierarchy, and a short chain that stays finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.models.obs import make_posterior_operator as jax_make_posterior_operator
from parmgmc_tpu.models.problems import gmrf_2d as jax_gmrf_2d
from parmgmc_tpu.models.problems import squared_shifted_laplace_fd as jax_squared
from parmgmc_tpu.operators import stencil as jst
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu.samplers.registry import build_sampler as jax_build_sampler
from parmgmc_tpu.samplers.sor import NaturalGibbsSampler as JaxNaturalGibbsSampler
from parmgmc_tpu.samplers.sor import natural_sweep as jax_natural_sweep
from parmgmc_tpu_torch import convert
from parmgmc_tpu_torch.chain import init_chain, sample_moments
from parmgmc_tpu_torch.models.obs import make_posterior_operator
from parmgmc_tpu_torch.models.problems import gmrf_2d, squared_shifted_laplace_fd
from parmgmc_tpu_torch.operators import stencil as st
from parmgmc_tpu_torch.operators.transfer import GeometricTransfer
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
from parmgmc_tpu_torch.samplers.patch_gibbs import PatchGibbsSampler
from parmgmc_tpu_torch.samplers.registry import build_sampler, register_sampler
from parmgmc_tpu_torch.samplers.sor import NaturalGibbsSampler, lexicographic_sweep, natural_sweep
from parmgmc_tpu_torch.samplers.woodbury import WoodburySampler

# the entry points default to the card; these tests run on the host
DEV = "cpu"
F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _nine_point():
    """A 9-point Galerkin level (5 x 5) of a 9 x 9 FD operator, both sides."""
    op = st.compress_stencil(st.galerkin_coarse_operator(st.shifted_laplace_fd((9, 9), 1.3, F64, device=DEV)))
    jop = jst.compress_stencil(jst.galerkin_coarse_operator(jst.shifted_laplace_fd((9, 9), 1.3, dtype=jnp.float64)))
    return op, jop


OPS = {
    "star 2D": lambda: (st.shifted_laplace_fd((6, 5), 1.3, F64, device=DEV),
                        jst.shifted_laplace_fd((6, 5), 1.3, dtype=jnp.float64)),
    "star 3D": lambda: (st.shifted_laplace_fd((4, 3, 5), 0.8, F64, device=DEV),
                        jst.shifted_laplace_fd((4, 3, 5), 0.8, dtype=jnp.float64)),
    "9-point": _nine_point,
    "squared": lambda: (squared_shifted_laplace_fd((7, 6), 1.1, F64, device=DEV),
                        jax_squared((7, 6), 1.1, dtype=jnp.float64)),
}


@pytest.mark.parametrize("case", list(OPS))
def test_natural_sweep_is_lexicographic_and_jax(case):
    op, jop = OPS[case]()
    assert op.is_star() == (case.startswith("star"))
    rs = np.random.RandomState(1)
    x0, b = rs.randn(*op.grid_shape), rs.randn(*op.grid_shape)
    for sweep in ("forward", "backward", "symmetric"):
        got = natural_sweep(op, torch.from_numpy(b), torch.from_numpy(x0), 1.35, sweep)
        seq = lexicographic_sweep(op, torch.from_numpy(b), torch.from_numpy(x0), 1.35, sweep)
        assert float((got - seq).abs().max()) < 1e-14 * float(seq.abs().max()), sweep
        want = jax_natural_sweep(jop, jnp.asarray(b), jnp.asarray(x0), 1.35, sweep)
        assert _rel(got, want) < 1e-12, sweep


@pytest.mark.parametrize("sweep", ["forward", "symmetric"])
def test_natural_gibbs_sampler_matches_jax(sweep):
    op, jop = _nine_point()
    smp = NaturalGibbsSampler.create(op, omega=1.2, sweep=sweep)
    jsmp = JaxNaturalGibbsSampler.create(jop, omega=1.2, sweep=sweep)
    assert smp.noise_shapes() == jsmp.noise_shapes()
    rs = np.random.RandomState(2)
    x, b = rs.randn(*op.grid_shape), rs.randn(*op.grid_shape)
    noises = [{"eta": rs.randn(*op.grid_shape)} for _ in smp.noise_shapes()]
    for bb in (None, b):
        got = smp.step_with_noise(torch.from_numpy(x), None if bb is None else torch.from_numpy(bb),
                                  convert.tree(noises, DEV))
        # the JAX sampler takes no b=None: zeros stand in for it
        want = jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(np.zeros_like(x) if bb is None else bb),
                                    jax.tree_util.tree_map(jnp.asarray, noises))
        assert _rel(got, want) < 1e-12
    _, xk = smp.step(3, torch.from_numpy(x), None)
    assert xk.shape == op.grid_shape and bool(torch.isfinite(xk).all())


def _numpy_noises(shapes, rs):
    if isinstance(shapes, tuple):
        return rs.randn(*shapes)
    if isinstance(shapes, dict):
        return {k: _numpy_noises(v, rs) for k, v in shapes.items()}
    return [_numpy_noises(v, rs) for v in shapes]


def _same_step(smp, jsmp, b, jb, tol):
    """smp.step_with_noise against jsmp's on the same numpy noises and x."""
    assert smp.noise_shapes() == jsmp.noise_shapes()
    rs = np.random.RandomState(7)
    x = rs.randn(*smp.grid_shape)
    noises = _numpy_noises(smp.noise_shapes(), rs)
    got = smp.step_with_noise(torch.from_numpy(x), b, convert.tree(noises, DEV))
    want = jsmp.step_with_noise(jnp.asarray(x), jb, jax.tree_util.tree_map(jnp.asarray, noises))
    assert _rel(got, want) < tol


def _posterior(shape, coords, radii, obsvals, sigma2=1e-2):
    op, f = make_posterior_operator(st.shifted_laplace_fd(shape, 1.0, F64, device=DEV), sigma2,
                                    coords, radii, obsvals)
    jop, jf = jax_make_posterior_operator(jst.shifted_laplace_fd(shape, 1.0, dtype=jnp.float64), sigma2,
                                          coords, radii, obsvals)
    return op, f, jop, jf


def test_readme_posterior_tree_matches_jax():
    """README: gmrf_2d(64), one ball, build_sampler(post_op, {"type":
    "mgmc", "n_pre": 2, "n_post": 2}) -- the linear LRC hierarchy."""
    op, f, jop, jf = _posterior((64, 64), [[0.25, 0.25]], [0.1], [0.8])
    cfg = {"type": "mgmc", "n_pre": 2, "n_post": 2}
    smp, jsmp = build_sampler(op, cfg), jax_build_sampler(jop, cfg)
    assert isinstance(smp, MGMCSampler) and isinstance(jsmp, JaxMGMCSampler)
    assert [o.grid_shape for o in smp.ops] == [tuple(o.grid_shape) for o in jsmp.ops] == [(64, 64), (32, 32), (16, 16)]
    assert all(isinstance(t, GeometricTransfer) for t in smp.transfers)
    assert all(isinstance(s, GibbsSampler) and s.is_lrc for s in smp.smoothers)
    assert isinstance(smp.coarse, CholeskySampler) and cfg == {"type": "mgmc", "n_pre": 2, "n_post": 2}
    _same_step(smp, jsmp, f, jf, 1e-10)


TREES = {
    "docstring": {"type": "mgmc", "n_levels": 3, "smoother": {"type": "gibbs", "omega": 1.0, "sweep": "symmetric"},
                  "n_pre": 2, "n_post": 2, "coarse": {"type": "cholesky"}},
    "natural": {"type": "mgmc", "coarsest_size": 8, "smoother": {"type": "gibbs", "ordering": "natural"}},
    "gibbs": {"type": "gibbs", "omega": 1.3, "sweep": "backward"},
}


@pytest.mark.parametrize("tree", list(TREES))
def test_prior_trees_match_jax(tree):
    op = gmrf_2d(9, 1.0, F64, device=DEV)
    jop = jax_gmrf_2d(9, 1.0, jnp.float64)
    smp, jsmp = build_sampler(op, TREES[tree]), jax_build_sampler(jop, TREES[tree])
    if tree == "natural":
        assert all(isinstance(s, NaturalGibbsSampler) for s in smp.smoothers)
    rs = np.random.RandomState(3)
    b = rs.randn(9, 9)
    _same_step(smp, jsmp, torch.from_numpy(b), jnp.asarray(b), 1e-10)


@pytest.mark.parametrize("inner", ["cholesky", "mgmc"])
def test_woodbury_trees_match_jax(inner):
    op, f, jop, jf = _posterior((8, 8), [[0.3, 0.4], [0.7, 0.6]], [0.2, 0.2], [0.5, -0.3])
    cfg = {"type": "woodbury", "sampler": {"type": inner}, "solver": "dense"}
    if inner == "mgmc":
        cfg["sampler"].update(coarsest_size=8, n_pre=2, n_post=2)
    smp, jsmp = build_sampler(op, cfg), jax_build_sampler(jop, cfg)
    assert isinstance(smp, WoodburySampler)
    _same_step(smp, jsmp, f, jf, 1e-10)
    with pytest.raises(TypeError):
        build_sampler(op.base, {"type": "woodbury"})


def test_patch_gibbs_tree_matches_jax():
    op = squared_shifted_laplace_fd((7, 6), 1.1, F64, device=DEV)
    jop = jax_squared((7, 6), 1.1, dtype=jnp.float64)
    smp, jsmp = build_sampler(op, {"type": "patch_gibbs"}), jax_build_sampler(jop, {"type": "patch_gibbs"})
    assert isinstance(smp, PatchGibbsSampler)
    b = np.random.RandomState(4).randn(7, 6)
    _same_step(smp, jsmp, torch.from_numpy(b), jnp.asarray(b), 1e-10)
    with pytest.raises(TypeError, match="stencil or graph"):
        build_sampler(object(), {"type": "patch_gibbs"})


def test_registry_refusals_and_extension():
    from parmgmc_tpu_torch.samplers.cholesky import SparseCholeskySampler

    op = gmrf_2d(6, 1.0, F64, device=DEV)
    assert isinstance(build_sampler(op, {"type": "cholesky", "mode": "sparse"}), SparseCholeskySampler)
    assert isinstance(build_sampler(op, {"type": "cholesky", "mode": "auto"}), CholeskySampler)
    auto = build_sampler(op, {"type": "cholesky", "mode": "auto", "dense_threshold": 20})
    assert isinstance(auto, SparseCholeskySampler)
    # the sparse factor of the stencil's CSR samples the dense law
    S = auto._sqrt_apply(np.eye(op.n))
    assert _rel(S @ S.T, np.linalg.inv(op.to_dense().numpy())) < 1e-12
    with pytest.raises(ValueError, match="unknown sampler type"):
        build_sampler(op, {"type": "hamiltonian"})
    assert isinstance(build_sampler(op, {"type": "cholesky", "mode": "dense"}), CholeskySampler)

    @register_sampler("test_scaled_gibbs")
    def _scaled(o, cfg):
        return GibbsSampler.create(o, omega=2.0 * cfg.pop("half_omega"))

    assert build_sampler(op, {"type": "test_scaled_gibbs", "half_omega": 0.6}).omega == 1.2


def test_readme_quick_start():
    """MGMCSampler.create(gmrf_2d(64), n_pre=2, n_post=2) with every other
    argument at its default: JAX's hierarchy, and a short chain (b = 0)
    that stays finite with a sane variance."""
    op = gmrf_2d(64, kappa=1.0, device=DEV)
    smp = MGMCSampler.create(op, n_pre=2, n_post=2)
    jsmp = JaxMGMCSampler.create(jax_gmrf_2d(64, kappa=1.0), n_pre=2, n_post=2)
    assert [o.grid_shape for o in smp.ops] == [tuple(o.grid_shape) for o in jsmp.ops] == [(64, 64), (32, 32), (16, 16)]
    assert all(isinstance(t, GeometricTransfer) for t in smp.transfers)
    for o, jo in zip(smp.ops[1:], jsmp.ops[1:]):
        assert o.offsets == jo.offsets and _rel(o.to_dense(), jo.to_dense()) < 1e-6
    b = torch.zeros(op.grid_shape)
    _, mean, var = sample_moments(smp, init_chain(smp, 0), b, 300, burnin=20)
    assert bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
    assert float(var.min()) > 0 and float(mean.abs().max()) < 5.0 * float(var.max()) ** 0.5
