"""The port's ``shard_sampler`` (``parmgmc_tpu_torch.parallel.mesh`` and
``.spmd``) against the JAX package (CPU).

JAX shards a sampler by placing its leaves and letting GSPMD partition
the step (``tests/test_parallel.py``); the sharded step is the unsharded
one.  Here the port's sharded step, on slots on the host
(``devices=["cpu"] * 8``), is held against JAX's UNSHARDED
``step_with_noise`` under the same numpy noises:

* meshes (8,) and (4, 2), symmetric Gibbs, linear and aggregate MGMC on
  a (32, 32) float64 grid: 1e-12 (Gibbs) and 1e-11 (MGMC), the JAX
  tolerances; the finest level in 8 distinct blocks;
* the keyed sharded step bit for bit the port's unsharded plain keyed
  step (``lax_variant``), also on 3D grids with chains split over a
  ``"chain"`` mesh axis, a symmetric V(2,2) and a W-cycle;
* the chain statistics of ``tests/test_parallel.py`` (rel < 0.05): 128
  chains x 64 steps on the (4, 2) mesh;
* graph chains over a ``"chain"`` axis equal the unsharded chains;
* the refusals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.operators.stencil import shifted_laplace_fd as jax_shifted_laplace_fd
from parmgmc_tpu.samplers.gibbs import GibbsSampler as JaxGibbsSampler
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu_torch import convert
from parmgmc_tpu_torch.models.mesh import matern_precision_mesh, unit_square_mesh
from parmgmc_tpu_torch.models.obs import make_posterior_operator
from parmgmc_tpu_torch.operators.graph import from_csr
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.parallel.mesh import make_mesh, shard_sampler
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
from parmgmc_tpu_torch.samplers.patch_gibbs import PatchGibbsSampler
from parmgmc_tpu_torch.samplers.registry import build_sampler, lax_variant

# the entry points default to the card; these tests run on the host
DEV = "cpu"
F64 = torch.float64
GRID = (32, 32)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _mesh(shape, names=None):
    return make_mesh(shape, axis_names=names, devices=[DEV] * int(np.prod(shape)))


def _noises(shapes, rng, batch=()):
    """The same standard-normal tree for the port and for JAX."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes, is_leaf=lambda s: isinstance(s, tuple))
    tree = jax.tree_util.tree_unflatten(treedef, [rng.standard_normal(tuple(s) + batch) for s in leaves])
    return convert.tree(tree, DEV), jax.tree_util.tree_map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _samplers(kind, kappa=3.0):
    op = shifted_laplace_fd(GRID, kappa, F64, device=DEV)
    jop = jax_shifted_laplace_fd(GRID, kappa, dtype=jnp.float64)
    if kind == "gibbs":
        return GibbsSampler.create(op, sweep="symmetric"), JaxGibbsSampler.create(jop, sweep="symmetric")
    coarsening = "aggregate" if kind == "aggregate" else "linear"
    return (MGMCSampler.create(op, n_levels=3, coarsening=coarsening),
            JaxMGMCSampler.create(jop, n_levels=3, coarsening=coarsening))


@pytest.mark.parametrize("mesh_shape", [(8,), (4, 2)])
@pytest.mark.parametrize("kind", ["gibbs", "linear", "aggregate"])
def test_step_with_noise_matches_jax(mesh_shape, kind):
    smp, jsmp = _samplers(kind)
    rng = np.random.default_rng(2)
    x, b = rng.standard_normal(GRID), np.ones(GRID)
    tn, jn = _noises(jsmp.noise_shapes(), rng)
    want = np.asarray(jax.jit(jsmp.step_with_noise)(jnp.asarray(x), jnp.asarray(b), jn))
    sh, layout = shard_sampler(smp, _mesh(mesh_shape))
    assert len(sh.levels[0].keys) == 8  # the finest level in 8 distinct blocks
    xs, bs = layout.shard(torch.from_numpy(x)), layout.shard(torch.from_numpy(b))
    got = layout.unshard(sh.step_with_noise(xs, bs, tn))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12 if kind == "gibbs" else 1e-11)
    # the keyed step: the unsharded plain keyed step, bit for bit
    k1, ref = lax_variant(smp).step(17, torch.from_numpy(x), torch.from_numpy(b))
    k2, out = sh.step(17, xs, bs)
    assert k1 == k2 and torch.equal(layout.unshard(out), ref)


def _keyed_case(case):
    if case == "chain-x":  # the dry run's first block: ("chain", "x") = (2, 4), 4 chains
        op = shifted_laplace_fd((16, 16, 16), 1.0, torch.float32, device=DEV)
        smp = MGMCSampler.create(op, n_levels=2, n_pre=1, n_post=1)
        return smp, _mesh((2, 4), ("chain", "x")), dict(min_local=2, grid_axes=("x", None, None)), 4
    op = shifted_laplace_fd((32, 8, 8), 1.0, F64, device=DEV)
    if case == "v22-symmetric":
        smp = MGMCSampler.create(op, n_pre=2, n_post=2, coarsest_size=16, sweep="symmetric")
    else:  # a W-cycle on the aggregate hierarchy, backward sweeps, two coarse draws
        smp = MGMCSampler.create(op, n_levels=3, coarsening="aggregate", gamma=2, sweep="backward", n_coarse=2)
    return smp, _mesh((4,), ("x",)), dict(grid_axes=("x", None, None)), 3


@pytest.mark.parametrize("case", ["chain-x", "v22-symmetric", "w-cycle"])
def test_keyed_step_is_the_unsharded_step(case):
    smp, mesh, kw, C = _keyed_case(case)
    sh, layout = shard_sampler(smp, mesh, **kw)
    assert sh.structured and len(sh.levels[0].split) == 1
    g = torch.Generator().manual_seed(3)
    x = torch.randn(tuple(smp.grid_shape) + (C,), generator=g, dtype=smp.dtype)
    b = torch.randn(tuple(smp.grid_shape), generator=g, dtype=smp.dtype)
    plain = lax_variant(smp)
    key, xs = 4, layout.shard(x)
    for _ in range(2):
        key, xs = sh.step(key, xs, layout.shard(b))
    k, ref = 4, x
    for _ in range(2):
        k, ref = plain.step(k, ref, b)
    assert k == key and torch.equal(layout.unshard(xs), ref)
    # the explicit-noise step with the chains as a trailing axis
    rng = np.random.default_rng(1)
    tn, _ = _noises(smp.noise_shapes(), rng, batch=(C,))
    tn = jax.tree_util.tree_map(lambda t: t.to(smp.dtype), tn)
    got = layout.unshard(sh.step_with_noise(layout.shard(x), None, tn))
    assert torch.equal(got, smp.step_with_noise(x, None, tn))


def test_sharded_chain_statistics():
    """128 chains x 64 steps of the keyed sharded MGMC chain on the (4, 2)
    mesh: the mean of the 8192 samples within rel 0.05 of A^{-1} b (the
    gate of tests/test_parallel.py::test_sharded_chain_statistics)."""
    op = shifted_laplace_fd(GRID, 10.0, F64, device=DEV)
    smp = MGMCSampler.create(op, n_levels=3)
    sh, layout = shard_sampler(smp, _mesh((4, 2)))
    C, burn, n = 128, 8, 64
    bs = layout.shard(torch.ones(GRID, dtype=F64))
    key, xs = 1, layout.shard(torch.zeros(GRID + (C,), dtype=F64))
    for _ in range(burn):
        key, xs = sh.step(key, xs, bs)
    acc = [torch.zeros_like(x) for x in xs]
    for _ in range(n):
        key, xs = sh.step(key, xs, bs)
        acc = [a + x for a, x in zip(acc, xs)]
    mean = layout.unshard(acc).mean(dim=-1).numpy() / n
    ex = np.linalg.solve(op.to_dense().numpy(), np.ones(op.n)).reshape(GRID)
    assert np.linalg.norm(mean - ex) / np.linalg.norm(ex) < 0.05


def test_graph_chains_over_a_chain_axis():
    """Graph samplers split their chains: 8 chains on a ("chain",) mesh of
    8 slots equal the unsharded chain-major chains (3 keyed steps)."""
    pts, cells = unit_square_mesh(9)
    op = from_csr(matern_precision_mesh(pts, cells, 2.0), dtype=torch.float32, device=DEV)
    smp = MGMCSampler.create(op, coarsest_size=12)
    sh, layout = shard_sampler(smp, _mesh((8,), ("chain",)))
    assert not sh.structured
    b = torch.zeros(op.n, dtype=torch.float32)
    key, xs = 3, layout.shard(torch.zeros((op.n, 8), dtype=torch.float32))
    assert all(x.shape == (op.n, 1) for x in xs)
    k, ref = 3, torch.zeros((op.n, 8), dtype=torch.float32)
    for _ in range(3):
        key, xs = sh.step(key, xs, layout.shard(b))
        k, ref = smp.step(k, ref, b)
    got = layout.unshard(xs)
    assert key == k and float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_refusals():
    op = shifted_laplace_fd((16, 16, 16), 1.0, torch.float32, device=DEV)
    m = _mesh((4,), ("x",))
    rng = np.random.default_rng(0)
    post, _ = make_posterior_operator(op, 0.01, 0.2 + 0.6 * rng.random((2, 3)), np.full(2, 0.2))
    with pytest.raises(ValueError, match="LRC"):
        shard_sampler(GibbsSampler.create(post), m)
    with pytest.raises(ValueError, match="LRC"):
        shard_sampler(MGMCSampler.create(post, n_levels=2, coarsening="aggregate"), m)
    with pytest.raises(ValueError, match="patch"):
        shard_sampler(PatchGibbsSampler.create(op), m)
    with pytest.raises(ValueError, match="CholeskySampler"):
        shard_sampler(CholeskySampler.create(shifted_laplace_fd((8, 8), 1.0, device=DEV)), m)
    natural = build_sampler(op, {"type": "mgmc", "n_levels": 2, "smoother": {"type": "gibbs", "ordering": "natural"}})
    with pytest.raises(ValueError, match="NaturalGibbsSampler"):
        shard_sampler(natural, m)
    pts, cells = unit_square_mesh(6)
    graph = MGMCSampler.create(from_csr(matern_precision_mesh(pts, cells, 2.0), device=DEV), coarsest_size=12)
    with pytest.raises(ValueError, match="graph_sharded"):
        shard_sampler(graph, _mesh((2,), ("x",)))
    smp = MGMCSampler.create(op, n_levels=2)
    with pytest.raises(ValueError, match="grid_axes"):
        shard_sampler(smp, _mesh((2, 2), ("chain", "x")), grid_axes=("chain", None, None))
    sh, layout = shard_sampler(smp, _mesh((2, 2), ("chain", "x")), grid_axes=("x", None, None))
    with pytest.raises(ValueError, match="chain axis"):
        sh.step(0, layout.shard(torch.zeros(op.grid_shape)), None)
