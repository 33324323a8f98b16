"""The port's mesh samplers against the JAX package (CPU, float64).

* ``GraphPatchGibbsSampler``: set-up equal to JAX's (patch size, colour
  count, centres), ``step_with_noise`` against JAX on the same noises
  (1e-12; batched Cholesky here, JAX's unrolled one there), the sampler
  carried across from the JAX object, the invariance identity (< 1e-10),
  a chain-major step equal to single-chain steps; MGMC with the graph
  patch smoother from the registry (ex9's configuration on a mesh)
  against JAX and invariant;
* ``SparseCholeskySampler``: the covariance of its sampling map equal to
  the dense A^{-1} (prior) and A_post^{-1} (Matheron posterior) to 1e-12,
  its mean to the dense solve, tensors in and out on the caller's device;
* ``exact_sampler``'s dispatch and the registry's ``cholesky`` modes
  ``auto`` and ``sparse`` and graph ``patch_gibbs`` entry; the registry's
  Woodbury tree on a graph posterior against JAX (1e-11) and invariant;
* ``MaternMeshSampler``: the P1 posterior operator and right-hand side
  against JAX's, CG2 invariance, ``sample``/``sample_mean_and_var`` in
  original order, and a keyed chain-major moments check against the dense
  solve (2000 chains, 20 steps each, as ``tests/test_unstructured.py``'s
  chain-statistics bound: relative mean error < 0.03); the refusal of the
  vmapped chain layout (ROADMAP.md item 17a).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.models.matern import MaternMeshSampler as JaxMaternMeshSampler
from parmgmc_tpu.operators.graph import from_csr as jax_from_csr
from parmgmc_tpu.samplers.patch_gibbs import GraphPatchGibbsSampler as JaxGraphPatchGibbsSampler
from parmgmc_tpu.samplers.registry import build_sampler as jax_build_sampler
from parmgmc_tpu_torch import convert
from parmgmc_tpu_torch.models import mesh
from parmgmc_tpu_torch.models.matern import MaternMeshSampler, batched_chains_supported
from parmgmc_tpu_torch.operators.graph import from_csr
from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler, SparseCholeskySampler, exact_sampler
from parmgmc_tpu_torch.samplers.patch_gibbs import GraphPatchGibbsSampler
from parmgmc_tpu_torch.samplers.registry import build_sampler
from parmgmc_tpu_torch.testing import invariance_error

# the entry points default to the card; these tests run on the host
DEV = "cpu"
TOL = 1e-12
INV = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a))


def _ops(n=6, kappa=2.0):
    A = mesh.matern_precision_mesh(*mesh.unit_square_mesh(n), kappa)
    return from_csr(A, device=DEV), jax_from_csr(A, dtype=jnp.float64)


def _noises(shapes, rng, batch=()):
    leaves, treedef = jax.tree_util.tree_flatten(shapes, is_leaf=lambda s: isinstance(s, tuple))
    tree = jax.tree_util.tree_unflatten(treedef, [rng.standard_normal(tuple(s) + batch) for s in leaves])
    return convert.tree(tree, DEV), jax.tree_util.tree_map(jnp.asarray, tree)


def test_graph_patch_gibbs_matches_jax():
    op, jop = _ops()
    smp, jsmp = GraphPatchGibbsSampler.create(op), JaxGraphPatchGibbsSampler.create(jop)
    assert (smp.kmax, smp.ncolors) == (jsmp.kmax, jsmp.ncolors)
    sets = np.asarray(jsmp.color_sets)
    for (centres, *_), cs in zip(smp.passes, sets):
        np.testing.assert_array_equal(centres.numpy(), cs[cs < op.n])
    rng = np.random.default_rng(0)
    x, b = rng.standard_normal(op.n), rng.standard_normal(op.n)
    tn, jn = _noises(jsmp.noise_shapes(), rng)
    want = jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(b), jn)
    assert _rel(smp.step_with_noise(_t(x), _t(b), tn), want) < TOL
    carried = convert.graph_patch_gibbs_sampler(jsmp, DEV)
    assert _rel(carried.step_with_noise(_t(x), _t(b), tn), want) < TOL
    assert _rel(smp.step_with_noise(_t(x), None, tn), jsmp.step_with_noise(jnp.asarray(x), None, jn)) < TOL
    assert max(invariance_error(smp, op, _t(b))) < INV


def test_graph_patch_gibbs_chain_major():
    op, _ = _ops()
    smp = GraphPatchGibbsSampler.create(op)
    C = 3
    rng = np.random.default_rng(1)
    X, b = rng.standard_normal((op.n, C)), _t(rng.standard_normal(op.n))
    tn, _ = _noises(smp.noise_shapes(), rng, batch=(C,))
    got = smp.step_with_noise(_t(X), b, tn)
    for c in range(C):
        one = smp.step_with_noise(_t(X[:, c]), b, [{"eta": tn[0]["eta"][..., c]}])
        assert _rel(got[:, c], one) < 1e-13
    key, y = smp.step(5, _t(X), b)
    assert y.shape == (op.n, C) and bool(torch.isfinite(y).all())


def test_mgmc_with_graph_patch_smoother_matches_jax():
    op, jop = _ops()
    cfg = {"type": "mgmc", "coarsest_size": 12, "smoother": {"type": "patch_gibbs"}}
    smp, jsmp = build_sampler(op, cfg), jax_build_sampler(jop, cfg)
    assert isinstance(smp.smoothers[0], GraphPatchGibbsSampler)
    rng = np.random.default_rng(3)
    x, b = rng.standard_normal(op.n), rng.standard_normal(op.n)
    tn, jn = _noises(jsmp.noise_shapes(), rng)
    want = jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(b), jn)
    assert _rel(smp.step_with_noise(_t(x), _t(b), tn), want) < TOL
    assert _rel(convert.graph_mgmc_sampler(jsmp, DEV).step_with_noise(_t(x), _t(b), tn), want) < TOL
    assert max(invariance_error(smp, op, _t(b))) < INV
    assert not batched_chains_supported(smp)


def _posterior(op):
    pts, cells = mesh.unit_square_mesh(6)
    B, si, f = mesh.mesh_observation_mats(pts, cells, 0.05, [[0.3, 0.3], [0.7, 0.6], [0.5, 0.2]],
                                          [0.25, 0.2, 0.2], [1.0, -0.5, 0.3])
    perm = op.perm.numpy()
    return LRCOperator(base=op, B=_t(B[perm]), sigma_inv=_t(si)), f[perm]


def test_sparse_cholesky_prior_is_exact():
    op, _ = _ops()
    smp = SparseCholeskySampler.create(op)
    S = smp._sqrt_apply(np.eye(op.n))
    Ainv = np.linalg.inv(op.to_dense().numpy())
    assert _rel(S @ S.T, Ainv) < TOL
    b = np.random.default_rng(2).standard_normal(op.n)
    mu = smp.mean(_t(b))
    assert mu.device.type == "cpu" and _rel(mu, Ainv @ b) < TOL
    xs = smp.sample(3, 4, b=_t(b))
    assert xs.shape == (4, op.n) and xs.dtype == torch.float64
    key, y = smp.step(7, None, _t(b))
    assert y.shape == (op.n,) and isinstance(key, int)


def test_sparse_cholesky_matheron_posterior_is_exact():
    from scipy.linalg import cho_solve

    op, _ = _ops()
    post, f = _posterior(op)
    smp = SparseCholeskySampler.create(post)
    lr = smp._lrc
    k = post.k
    S = smp._sqrt_apply(np.eye(op.n))
    CM = lr["C"] @ cho_solve((lr["M_cho"], True), np.eye(k))
    K_eta = S - CM @ (lr["B"].T @ S)
    K_eps = -CM @ np.diag(np.sqrt(lr["sigma"]))
    Apost = post.to_dense().numpy()
    assert _rel(K_eta @ K_eta.T + K_eps @ K_eps.T, np.linalg.inv(Apost)) < TOL
    assert _rel(smp.mean(_t(f)), np.linalg.solve(Apost, f)) < TOL


def test_exact_sampler_and_registry_cholesky_modes():
    op, _ = _ops()
    assert isinstance(exact_sampler(op), CholeskySampler)
    assert isinstance(exact_sampler(op, dense_threshold=10), SparseCholeskySampler)
    assert isinstance(build_sampler(op, {"type": "cholesky", "mode": "auto"}), CholeskySampler)
    auto = build_sampler(op, {"type": "cholesky", "mode": "auto", "dense_threshold": 10})
    assert isinstance(auto, SparseCholeskySampler)
    assert isinstance(build_sampler(op, {"type": "cholesky", "mode": "sparse"}), SparseCholeskySampler)
    assert isinstance(build_sampler(op, {"type": "patch_gibbs"}), GraphPatchGibbsSampler)


def test_matern_mesh_sampler_matches_jax_and_is_exact():
    pts, cells = mesh.unit_square_mesh(5)
    obs = dict(sigma2=0.1, coords=np.array([[0.35, 0.45]]), radii=np.array([0.2]), values=np.array([1.0]))
    ms = MaternMeshSampler(points=pts, cells=cells, kappa=2.0, coarsest_size=12, observations=obs, device=DEV)
    jms = JaxMaternMeshSampler(points=pts, cells=cells, kappa=2.0, coarsest_size=12, observations=obs)
    assert ms.sampler.n_levels == jms.sampler.n_levels >= 2
    assert _rel(ms.operator.B, jms.operator.B) < TOL and _rel(ms.b, jms.b) < TOL
    assert max(invariance_error(ms.sampler, ms.operator, ms.b)) < INV
    # CG2: vertices + edge midpoints
    pts4, cells4 = mesh.unit_square_mesh(4)
    cg2 = MaternMeshSampler(points=pts4, cells=cells4, kappa=2.0, order=2, coarsest_size=16, observations=obs,
                            device=DEV)
    assert cg2.n == 25 + 56
    assert max(invariance_error(cg2.sampler, cg2.operator, cg2.b)) < 1e-9


def test_matern_mesh_sampler_chain_major_moments():
    pts, cells = mesh.unit_square_mesh(5)
    obs = dict(sigma2=0.01, coords=np.array([[0.3, 0.4], [0.7, 0.6]]), radii=np.array([0.2, 0.2]),
               values=np.array([1.0, -0.5]))
    ms = MaternMeshSampler(points=pts, cells=cells, kappa=5.0, coarsest_size=10, observations=obs, device=DEV, seed=3)
    Apost = ms.operator.to_dense().numpy()
    mu_int = np.linalg.solve(Apost, ms.b.numpy())
    mu = mu_int[ms.op.iperm.numpy()]  # original node order
    var = np.diag(np.linalg.inv(Apost))[ms.op.iperm.numpy()]
    assert batched_chains_supported(ms.sampler)
    ms.sample_chains(5, 2000)  # burn-in
    out = ms.sample_chains(20, 2000).numpy()  # (C, steps, n), original order
    assert out.shape == (2000, 20, ms.n)
    samples = out.reshape(-1, ms.n)
    rel = np.linalg.norm(samples.mean(0) - mu) / np.linalg.norm(mu)
    assert rel < 0.03, rel
    assert np.abs(samples.var(0) / var - 1).max() < 0.15
    # QOI traces per chain, in original order
    w = torch.zeros(ms.n, dtype=torch.float64)
    w[0] = 1.0
    ms.set_qoi(lambda x: x @ w)
    q = ms.sample_chains(3, 2000)
    assert q.shape == (2000, 3)
    assert _rel(ms._chain_states[2000].x[ms.op.iperm][0], q[:, -1]) < 1e-15
    # the single chain, and its moments, in original order
    assert ms.sample(4).shape == (4,)
    mean, v = ms.sample_mean_and_var(50)
    assert mean.shape == (ms.n,) and bool(torch.isfinite(v).all())


def test_matern_mesh_sampler_refuses_the_vmapped_layout():
    """A sampler outside the chain-major layout (patch smoothers on the
    graph levels) once was refused here; it now runs its chains one at a
    time (chain.multi_chain), each chain the plain chain under its key
    split(fold_in(key, C), C), in original node order."""
    from parmgmc_tpu_torch import keys
    from parmgmc_tpu_torch.chain import init_chain, sample_chain

    pts, cells = mesh.unit_square_mesh(4)
    ms = MaternMeshSampler(points=pts, cells=cells, kappa=2.0, coarsest_size=12, device=DEV)
    ms.sampler = build_sampler(ms.op, {"type": "mgmc", "coarsest_size": 12, "smoother": {"type": "patch_gibbs"}})
    assert not batched_chains_supported(ms.sampler)
    w = torch.linspace(0.0, 1.0, ms.n, dtype=torch.float64)
    ms.set_qoi(lambda x: x @ w)
    q = ms.sample_chains(2, 4)
    assert q.shape == (4, 2) and torch.isfinite(q).all()
    for c, k in enumerate(keys.split(keys.fold_in(ms.state.key, 4), 4)):
        _, qc = sample_chain(ms.sampler, init_chain(ms.sampler, k), ms.b, 2, extract=lambda x: x[ms.op.iperm] @ w)
        assert torch.equal(qc, q[c])


def test_woodbury_on_a_graph_posterior_matches_jax():
    """The registry's Woodbury tree around the dense Cholesky prior sampler
    on a graph posterior: its step against JAX's on the same noises and
    exactly invariant."""
    from parmgmc_tpu.operators.lrc import LRCOperator as JaxLRCOperator

    op, jop = _ops()
    post, f = _posterior(op)
    jpost = JaxLRCOperator(base=jop, B=jnp.asarray(post.B.numpy()), sigma_inv=jnp.asarray(post.sigma_inv.numpy()))
    cfg = {"type": "woodbury", "sampler": {"type": "cholesky"}}
    smp, jsmp = build_sampler(post, cfg), jax_build_sampler(jpost, cfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal(op.n)
    tn, jn = _noises(jsmp.noise_shapes(), rng)
    want = jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(f), jn)
    assert _rel(smp.step_with_noise(_t(x), _t(f), tn), want) < 1e-11
    assert max(invariance_error(smp, post, _t(f))) < INV
