"""The port's graph operators, transfers and graph samplers against the
JAX package (CPU, float64).

* ``GraphOperator.apply`` and ``sor_sweep`` (forward, backward,
  symmetric; (n,) and chain-major (n, C)) against JAX, on a small mesh and
  on one past 8192 rows, where JAX gathers one ELL column at a time and the
  port one flat block (a different summation order): 1e-12 relative;
* ``SparseTransfer`` prolong and restrict against JAX (1e-12);
* ``aggregation_hierarchy`` of 3 levels equal to JAX's: every level's
  permutation, colour blocks and ELL arrays, every transfer, and B_c on
  an LRC hierarchy (values to 1e-12);
* ``step_with_noise`` of graph Gibbs, LRC graph Gibbs and algebraic MGMC
  (prior and LRC) against JAX on the same noises (1e-12), and the sampler
  carried across from the JAX object (``convert.graph_mgmc_sampler``);
* the invariance identity < 1e-10 for Gibbs (forward, symmetric),
  algebraic MGMC, LRC MGMC and the geometric hierarchy (prior, and the
  ``MaternMeshSampler(hierarchy="geometric")`` posterior);
* one chain-major step on (n, C) equal to C single-chain steps under the
  same explicit noise (1e-13), and a keyed chain-major step;
* the chain kernels' eligibility checks say no on every graph level, and
  the deferred chain refuses a graph sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.models import mesh as jmesh
from parmgmc_tpu.operators.graph import from_csr as jax_from_csr
from parmgmc_tpu.operators.lrc import LRCOperator as JaxLRCOperator
from parmgmc_tpu.operators.transfer import sparse_transfer_from_csr as jax_sparse_transfer
from parmgmc_tpu.samplers.gibbs import GibbsSampler as JaxGibbsSampler
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu_torch import convert
from parmgmc_tpu_torch.chain import init_chain, sample_chain, sample_chain_deferred
from parmgmc_tpu_torch.models import mesh
from parmgmc_tpu_torch.models.matern import MaternMeshSampler
from parmgmc_tpu_torch.operators.aggregation import aggregation_hierarchy
from parmgmc_tpu_torch.operators.graph import from_csr
from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.operators.transfer import SparseTransfer, sparse_transfer_from_csr
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
from parmgmc_tpu_torch.testing import invariance_error

# the entry points default to the card; these tests run on the host
DEV = "cpu"
TOL = 1e-12
INV = 1e-10
OBS = dict(sigma2=0.01, coords=[[0.3, 0.3], [0.7, 0.6]], radii=[0.25, 0.2], values=[1.0, -0.5])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a))


def _mesh(kind):
    """(points, cells): the small unit square, the twice-refined 3x3 square
    (169 nodes, three algebraic levels at coarsest_size 12), or the
    91x91 square (8464 rows: the JAX prefix-gather path)."""
    if kind == "small":
        return mesh.unit_square_mesh(6)
    if kind == "large":
        return mesh.unit_square_mesh(91)
    pts, cells = mesh.unit_square_mesh(3)
    for _ in range(2):
        pts, cells = mesh.refine(pts, cells)
    return pts, cells


def _ops(kind, kappa=2.0):
    A = mesh.matern_precision_mesh(*_mesh(kind), kappa)
    return from_csr(A, device=DEV), jax_from_csr(A, dtype=jnp.float64)


def _lrc(kind="refined"):
    pts, cells = _mesh(kind)
    op, jop = _ops(kind)
    B, si, f = mesh.mesh_observation_mats(pts, cells, OBS["sigma2"], OBS["coords"], OBS["radii"], OBS["values"])
    perm = op.perm.numpy()
    lrc = LRCOperator(base=op, B=_t(B[perm]), sigma_inv=_t(si))
    jlrc = JaxLRCOperator(base=jop, B=jnp.asarray(B[perm]), sigma_inv=jnp.asarray(si))
    return lrc, jlrc, f[perm]


def _noises(shapes, rng, batch=()):
    """The same standard-normal tree as numpy and as the two packages'
    arrays."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes, is_leaf=lambda s: isinstance(s, tuple))
    draws = [rng.standard_normal(tuple(s) + batch) for s in leaves]
    tree = jax.tree_util.tree_unflatten(treedef, draws)
    return convert.tree(tree, DEV), jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("kind", ["small", "large"])
def test_apply_and_sor_sweeps_match_jax(kind):
    op, jop = _ops(kind)
    assert (op.n >= 8192) == (kind == "large") and jop._use_prefix() == (kind == "large")
    rng = np.random.default_rng(0)
    x, b = rng.standard_normal(op.n), rng.standard_normal(op.n)
    assert _rel(op.apply(_t(x)), jop.apply(jnp.asarray(x))) < TOL
    xc = rng.standard_normal((op.n, 3))
    assert _rel(op.apply(_t(xc)), jop.apply(jnp.asarray(xc))) < TOL
    for sweep in ("forward", "backward", "symmetric"):
        want = jop.sor_sweep(jnp.asarray(b), jnp.asarray(x), 1.1, sweep)
        assert _rel(op.sor_sweep(_t(b), _t(x), 1.1, sweep), want) < TOL, sweep
        # chain-major, b shared by every chain
        want = jop.sor_sweep(jnp.asarray(b), jnp.asarray(xc), 1.1, sweep)
        got = op.sor_sweep(_t(b), _t(xc), 1.1, sweep)
        assert got.shape == (op.n, 3) and _rel(got, want) < TOL, sweep


def test_sparse_transfer_matches_jax():
    import scipy.sparse as sp

    rng = np.random.default_rng(1)
    P = sp.random(40, 9, density=0.2, random_state=2, format="csr") + sp.eye(40, 9, format="csr")
    tr, jtr = sparse_transfer_from_csr(P, device=DEV), jax_sparse_transfer(P, dtype=jnp.float64)
    assert isinstance(tr, SparseTransfer)
    for name in ("p_cols", "pt_cols", "p_vals", "pt_vals"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jtr, name)))
    for shape in ((9,), (9, 4)):
        xc = rng.standard_normal(shape)
        assert _rel(tr.prolong(_t(xc)), jtr.prolong(jnp.asarray(xc))) < TOL
        assert _rel(tr.prolong(_t(xc)), P @ xc) < TOL
        xf = rng.standard_normal((40,) + shape[1:])
        assert _rel(tr.restrict(_t(xf)), jtr.restrict(jnp.asarray(xf))) < TOL
        assert _rel(tr.restrict(_t(xf)), P.T @ xf) < TOL


@pytest.mark.parametrize("posterior", [False, True])
def test_aggregation_hierarchy_matches_jax(posterior):
    if posterior:
        op, jop, _ = _lrc()
    else:
        op, jop = _ops("refined")
    ops, transfers = aggregation_hierarchy(op, coarsest_size=12)
    jsmp = JaxMGMCSampler.create(jop, coarsest_size=12)
    assert [o.n for o in ops] == [o.n for o in jsmp.ops] == [169, 25, 4]
    for o, jo in zip(ops, jsmp.ops):
        g, jg = (o.base, jo.base) if posterior else (o, jo)
        assert g.color_starts == jg.color_starts and g.color_counts == jg.color_counts
        for name in ("perm", "iperm", "cols"):
            np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(jg, name)))
        assert _rel(g.vals, jg.vals) < TOL and _rel(g.diag, jg.diag) < TOL
        if posterior:
            assert _rel(o.B, jo.B) < TOL
    for t, jt in zip(transfers, jsmp.transfers):
        for name in ("p_cols", "pt_cols"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(jt, name)))
        assert _rel(t.p_vals, jt.p_vals) < TOL and _rel(t.pt_vals, jt.pt_vals) < TOL
    # Galerkin exactness in each level's internal order, all three levels
    for l in range(2):
        A, Ac = ops[l].to_dense().numpy(), ops[l + 1].to_dense().numpy()
        P = np.stack([transfers[l].prolong(_t(e)).numpy() for e in np.eye(ops[l + 1].n)], axis=1)
        assert _rel(P.T @ A @ P, Ac) < TOL


@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("posterior", [False, True])
def test_gibbs_step_with_noise_matches_jax(sweep, posterior):
    if posterior:
        op, jop, f = _lrc("small")
    else:
        (op, jop), f = _ops("small"), None
    smp, jsmp = GibbsSampler.create(op, omega=1.1, sweep=sweep), JaxGibbsSampler.create(jop, omega=1.1, sweep=sweep)
    assert not smp.has_kernel and smp.fd_params is None
    rng = np.random.default_rng(3)
    x = rng.standard_normal(op.n)
    b = rng.standard_normal(op.n) if f is None else f
    tn, jn = _noises(jsmp.noise_shapes(), rng)
    got = smp.step_with_noise(_t(x), _t(b), tn)
    assert _rel(got, jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(b), jn)) < TOL


@pytest.mark.parametrize("posterior", [False, True])
def test_mgmc_step_with_noise_matches_jax(posterior):
    if posterior:
        op, jop, b = _lrc()
    else:
        (op, jop), b = _ops("refined"), np.random.default_rng(4).standard_normal(169)
    smp = MGMCSampler.create(op, coarsest_size=12)
    jsmp = JaxMGMCSampler.create(jop, coarsest_size=12)
    carried = convert.graph_mgmc_sampler(jsmp, DEV)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(op.n)
    tn, jn = _noises(jsmp.noise_shapes(), rng)
    want = jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(b), jn)
    assert _rel(smp.step_with_noise(_t(x), _t(b), tn), want) < TOL
    assert _rel(carried.step_with_noise(_t(x), _t(b), tn), want) < TOL


def test_invariance_gibbs_and_algebraic_mgmc():
    op, _ = _ops("small")
    b = _t(np.random.default_rng(1).standard_normal(op.n))
    for sweep in ("forward", "symmetric"):
        assert max(invariance_error(GibbsSampler.create(op, omega=1.1, sweep=sweep), op, b)) < INV, sweep
    op, _ = _ops("refined")
    b = _t(np.random.default_rng(2).standard_normal(op.n))
    smp = MGMCSampler.create(op, coarsest_size=12)
    assert smp.n_levels == 3 and max(invariance_error(smp, op, b)) < INV


def test_invariance_lrc_mgmc():
    lrc, _, f = _lrc()
    smp = MGMCSampler.create(lrc, coarsest_size=12)
    assert smp.n_levels == 3 and all(isinstance(o, LRCOperator) for o in smp.ops)
    assert max(invariance_error(smp, lrc, _t(f))) < INV


def test_invariance_geometric_hierarchy():
    pts, cells = mesh.unit_square_mesh(3)
    Ps = []
    for _ in range(2):
        pts, cells, P = mesh.refine(pts, cells, True)
        Ps.append(P)
    A = mesh.matern_precision_mesh(pts, cells, 2.0)
    op = from_csr(A, device=DEV)
    ops, transfers = mesh.geometric_mgmc_hierarchy(op, Ps)
    jops, jtransfers = jmesh.geometric_mgmc_hierarchy(jax_from_csr(A, dtype=jnp.float64), Ps)
    assert [o.n for o in ops] == [o.n for o in jops] == [169, 49, 16]
    for o, jo in zip(ops, jops):
        np.testing.assert_array_equal(o.perm.numpy(), np.asarray(jo.perm))
        assert _rel(o.vals, jo.vals) < TOL
    for t, jt in zip(transfers, jtransfers):
        assert _rel(t.p_vals, jt.p_vals) < TOL
    from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler

    smp = MGMCSampler.from_levels(ops, transfers, CholeskySampler.create(ops[-1]))
    b = _t(np.random.default_rng(5).standard_normal(op.n))
    assert max(invariance_error(smp, op, b)) < INV
    # the façade's geometric posterior
    ms = MaternMeshSampler(points=mesh.unit_square_mesh(3)[0], cells=mesh.unit_square_mesh(3)[1], kappa=2.0,
                           refinements=2, hierarchy="geometric", device=DEV,
                           observations=dict(sigma2=0.1, coords=np.array([[0.3, 0.4], [0.7, 0.6]]),
                                             radii=np.array([0.15, 0.15]), values=np.array([1.0, -0.5])))
    assert ms.sampler.n_levels == 3
    assert max(invariance_error(ms.sampler, ms.operator, ms.b)) < 1e-9


@pytest.mark.parametrize("which", ["gibbs_lrc", "mgmc", "mgmc_lrc"])
def test_chain_major_step_is_c_single_steps(which):
    if which == "mgmc":
        op, _ = _ops("refined")
        b = _t(np.random.default_rng(6).standard_normal(op.n))
    else:
        op, _, f = _lrc()
        b = _t(f)
    smp = GibbsSampler.create(op, sweep="symmetric") if which == "gibbs_lrc" else MGMCSampler.create(op, coarsest_size=12)
    C = 3
    rng = np.random.default_rng(7)
    X = rng.standard_normal((op.n, C))
    tn, _ = _noises(smp.noise_shapes(), rng, batch=(C,))
    got = smp.step_with_noise(_t(X), b, tn)
    for c in range(C):
        col = jax.tree_util.tree_map(lambda a: a[..., c], tn)
        assert _rel(got[:, c], smp.step_with_noise(_t(X[:, c]), b, col)) < 1e-13
    # keyed: the chain axis rides along
    st = init_chain(smp, 11, batch=(C,))
    assert st.x.shape == (op.n, C)
    st, q = sample_chain(smp, st, b, 2, extract=lambda x: x.mean(dim=0))
    assert q.shape == (2, C) and bool(torch.isfinite(st.x).all())


def test_graph_levels_take_no_chain_kernel():
    op, _ = _ops("refined")
    for smp in (MGMCSampler.create(op, coarsest_size=12, n_pre=1, n_post=0),
                MGMCSampler.create(op, coarsest_size=12, n_pre=1, n_post=0, coarsening="aggregate"),
                MGMCSampler.create(_lrc()[0], coarsest_size=12, n_pre=1, n_post=0)):
        assert smp.n_levels == 3
        assert not smp.deferred_eligible() and not smp._lrc_chain_eligible() and smp.lrc_aux is None
        assert not any(smp._block_level(l) for l in range(smp.n_levels - 1))
        assert not any(smp._tail_fused_eligible(l) for l in range(smp.n_levels))
        assert not any(s.has_kernel for s in smp.smoothers)
        with pytest.raises(NotImplementedError, match="deferred chain"):
            sample_chain_deferred(smp, init_chain(smp, 0), None, 2)
