"""The port's posterior building blocks against the JAX package (CPU).

* observations (B, Sigma^{-1}, f) bit for bit in float64, 3D and 2D;
* the window view (``with_patches``, ``Columns.of``): the same starts
  and values;
* the LRC operator's products dense and windowed (1e-12 float64, 1e-6
  float32), and the column stack's window products and the union's
  packed update against the JAX window functions;
* Gibbs on an LRC operator: the Woodbury factor (1e-10), the
  explicit-noise step on one shared noise tree (1e-12), the exact
  invariance identity (< 1e-10), and the keyed step with its draws off
  against the explicit step with zero noises (float32, 1e-5);
* the Woodbury sampler's factor and step (float64);
* LRC over a graph operator is taken (the mesh path), and an operator
  that is neither a stencil nor a graph is refused.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.models.obs import make_observation_mats as jax_observation_mats
from parmgmc_tpu.models.obs import make_posterior_operator as jax_posterior_operator
from parmgmc_tpu.operators import lrc as jax_lrc
from parmgmc_tpu.operators.stencil import shifted_laplace_fd as jax_shifted_laplace_fd
from parmgmc_tpu.samplers.cholesky import CholeskySampler as JaxCholeskySampler
from parmgmc_tpu.samplers.gibbs import GibbsSampler as JaxGibbsSampler
from parmgmc_tpu.samplers.gibbs import build_lrc_correction as jax_build_lrc_correction
from parmgmc_tpu.samplers.woodbury import WoodburySampler as JaxWoodburySampler
from parmgmc_tpu.samplers import woodbury as jax_woodbury
from parmgmc_tpu_torch import convert
from parmgmc_tpu_torch.kernels import rb_gibbs
from parmgmc_tpu_torch.models.obs import make_observation_mats, make_posterior_operator
from parmgmc_tpu_torch.operators import lrc
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.samplers import gibbs, mgmc, woodbury
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler, build_lrc_correction
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
from parmgmc_tpu_torch.samplers.woodbury import WoodburySampler
from parmgmc_tpu_torch.testing import invariance_error

# the entry points default to the card; these tests run on the host
DEV = "cpu"
F32, F64 = torch.float32, torch.float64
GRID = (16, 20, 24)
# two balls that overlap, one at the boundary
COORDS = np.array([[0.3, 0.4, 0.5], [0.45, 0.5, 0.55], [0.9, 0.1, 0.2]])
RADII = np.array([0.1, 0.12, 0.15])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _posterior(dtype=F64, grid=GRID, kappa=1.3, sigma2=0.1, radii=RADII):
    """(port operator, port f, JAX operator, JAX f) of the same problem."""
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    y = np.array([0.7, -1.1, 0.4])
    op, f = make_posterior_operator(shifted_laplace_fd(grid, kappa, dtype, device=DEV),
                                    sigma2, COORDS, radii, y)
    jop, jf = jax_posterior_operator(jax_shifted_laplace_fd(grid, kappa, dtype=jdt),
                                     sigma2, COORDS, radii, y)
    return op, f, jop, jf


@pytest.mark.parametrize("grid", [(16, 12, 20), (24, 20)])
def test_observation_mats_match_jax(grid):
    d = len(grid)
    coords, radii = COORDS[:, :d], RADII
    y = np.array([0.3, -2.0, 1.5])
    B, s, f = make_observation_mats(grid, 0.05, coords, radii, y, device=DEV)
    jB, js, jf = jax_observation_mats(grid, 0.05, coords, radii, y)
    assert B.dtype == F64 and B.shape == (*grid, 3)
    assert np.array_equal(B.numpy(), np.asarray(jB))  # the same balls and weights
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.abs(f.numpy() - np.asarray(jf)).max() <= 1e-12 * np.abs(np.asarray(jf)).max()
    # float32 is the float64 matrix rounded
    B32, _, _ = make_observation_mats(grid, 0.05, coords, radii, device=DEV, dtype=F32)
    assert torch.equal(B32, B.float())


def _starts(ps):
    return tuple(tuple(int(v) for v in st) for st in np.asarray(ps))


def test_patches_match_jax():
    op, _, jop, _ = _posterior()
    assert op.cols.windowed and jop.patch_vals is not None and op.cols.dense is op.B
    assert op.cols.starts == _starts(jop.patch_starts)
    assert np.array_equal(op.cols.vals.numpy(), np.asarray(jop.patch_vals))
    # the JAX operator carried across is the same operator
    conv = convert.lrc_operator(op.base, np.asarray(jop.B), np.asarray(jop.sigma_inv),
                                np.asarray(jop.patch_vals), np.asarray(jop.patch_starts), DEV)
    assert conv.cols.starts == op.cols.starts and torch.equal(conv.cols.vals, op.cols.vals)
    assert torch.equal(conv.B, op.B) and torch.equal(conv.cols.index, op.cols.index)
    # Columns.of on a wider stack (B shifted a ring outwards), on a
    # stack too wide for the fill and on one with an empty column
    wide = op.B + torch.roll(op.B, 1, dims=0) + torch.roll(op.B, 1, dims=2)
    got, want = lrc.Columns.of(wide), jax_lrc.column_patches(jnp.asarray(wide.numpy()))
    assert got.starts == _starts(want[1]) and got.dense is wide
    assert np.array_equal(got.vals.numpy(), np.asarray(want[0]))
    assert not lrc.Columns.of(wide, max_fill=0.05).windowed
    assert jax_lrc.column_patches(jnp.asarray(wide.numpy()), max_fill=0.05) is None
    empty = op.B.clone()
    empty[..., 1] = 0
    assert not lrc.Columns.of(empty).windowed
    assert not lrc.with_patches(lrc.LRCOperator(op.base, empty, op.sigma_inv)).cols.windowed


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("patched", [True, False])
def test_lrc_products_match_jax(dtype, patched):
    op, _, jop, _ = _posterior(dtype)
    if not patched:
        op = lrc.LRCOperator(op.base, op.B, op.sigma_inv)
        jop = jax_lrc.LRCOperator(base=jop.base, B=jop.B, sigma_inv=jop.sigma_inv)
    tol = 1e-12 if dtype == F64 else 1e-6
    rs = np.random.RandomState(3)
    x = rs.randn(*GRID).astype(np.float64 if dtype == F64 else np.float32)
    w = rs.randn(3).astype(x.dtype)
    tx, tw, jx, jw = torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x), jnp.asarray(w)
    assert _rel(op.bt_apply(tx), jop.bt_apply(jx)) < tol
    assert _rel(op.b_apply(tw), jop.b_apply(jw)) < tol
    assert _rel(op.b_apply_add(tw, tx), jop.b_apply_add(jw, jx)) < tol
    assert _rel(op.apply(tx), jop.apply(jx)) < tol
    assert torch.equal(tx, torch.from_numpy(x))  # the functional forms leave x alone
    y = tx.clone()
    assert op.b_apply_add_(tw, y) is y and _rel(y, jop.b_apply_add(jw, jx)) < tol
    small, _, jsmall, _ = _posterior(dtype, grid=(6, 8, 8), radii=(0.2, 0.25, 0.3))
    assert small.cols.windowed
    assert _rel(small.to_dense(), jsmall.to_dense()) < tol


def test_window_updates_match_jax():
    rs = np.random.RandomState(4)
    shape, m, k, box = (12, 14, 16), 3, 4, (5, 6, 4)
    pv = rs.randn(m, k, *box)
    starts = np.stack([rs.randint(0, shape[a] - box[a], size=k) for a in range(3)], axis=1)
    w, y = rs.randn(m, k), rs.randn(*shape)
    ps = _starts(starts)
    # m stacks on the same k windows: the union packs them as they are
    stacks = []
    for i in range(m):
        dense = torch.zeros(*shape, k, dtype=F64)
        for j, st in enumerate(ps):
            dense[lrc.window(st, box) + (j,)] = torch.from_numpy(pv[i, j])
        stacks.append(lrc.Columns(dense, torch.from_numpy(pv[i]), ps).indexed())
    union = lrc.ColumnUnion.of([(st, 1) for st in stacks], shape)
    assert union.packed and union.starts == ps and torch.equal(union.vals, torch.from_numpy(pv))
    got = union.add_(list(torch.from_numpy(w)), torch.tensor(y))
    want = jax_lrc.fused_patch_apply_add(jnp.asarray(pv), jnp.asarray(starts), jnp.asarray(w), jnp.asarray(y))
    assert _rel(got, want) < 1e-12
    got = stacks[0].add(torch.from_numpy(w[0]), torch.from_numpy(y))
    want = jax_lrc.patch_apply_add(jnp.asarray(pv[0]), jnp.asarray(starts), jnp.asarray(w[0]), jnp.asarray(y))
    assert _rel(got, want) < 1e-12
    got = stacks[1].dot(torch.from_numpy(y))
    want = [np.sum(pv[1, j] * y[tuple(slice(s, s + e) for s, e in zip(st, box))]) for j, st in enumerate(ps)]
    assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("sweep", ["forward", "backward"])
def test_lrc_correction_matches_jax(sweep):
    op, _, jop, _ = _posterior()
    got = build_lrc_correction(op.base, op.B, op.sigma_inv, 1.2, sweep)
    want = jax_build_lrc_correction(jop.base, jop.B, jop.sigma_inv, 1.2, sweep)
    assert got.shape == (*GRID, 3) and _rel(got, want) < 1e-10
    smp = GibbsSampler.create(op, omega=1.2, sweep=sweep)
    # only the factor of the sweep in use, with the view of its windows
    assert set(smp.Bb) == {sweep} and smp.woodbury() is smp.woodbury(sweep)
    Bb = smp.woodbury()
    assert torch.equal(Bb.dense, got) and Bb.windowed
    jsmp = JaxGibbsSampler.create(jop, omega=1.2, sweep=sweep, impl="lax")
    jvals = jsmp.Bb_fw_pv if sweep == "forward" else jsmp.Bb_bw_pv
    jstarts = jsmp.Bb_fw_ps if sweep == "forward" else jsmp.Bb_bw_ps
    assert Bb.starts == _starts(jstarts)
    assert _rel(Bb.vals, jvals) < 1e-10


def _numpy_noises(shapes, rs):
    if isinstance(shapes, tuple):
        return rs.randn(*shapes)
    if isinstance(shapes, dict):
        return {k: _numpy_noises(v, rs) for k, v in shapes.items()}
    return [_numpy_noises(v, rs) for v in shapes]


def _zeros(shapes, dtype=np.float32):
    if isinstance(shapes, tuple):
        return np.zeros(shapes, dtype)
    if isinstance(shapes, dict):
        return {k: _zeros(v, dtype) for k, v in shapes.items()}
    return [_zeros(v, dtype) for v in shapes]


@pytest.mark.parametrize("sweep", ["forward", "symmetric"])
def test_gibbs_lrc_step_with_noise_matches_jax(sweep):
    op, f, jop, jf = _posterior()
    smp = GibbsSampler.create(op, omega=1.1, sweep=sweep)
    jsmp = JaxGibbsSampler.create(jop, omega=1.1, sweep=sweep, impl="lax")
    assert smp.noise_shapes() == [{"eta": GRID, "eta_lr": (3,)}] * len(smp.noise_shapes())
    rs = np.random.RandomState(6)
    x = rs.randn(*GRID)
    noises = _numpy_noises(smp.noise_shapes(), rs)
    for tb, jb in ((f, jf), (None, None)):
        got = smp.step_with_noise(torch.from_numpy(x), tb, convert.tree(noises, DEV))
        want = jsmp.step_with_noise(jnp.asarray(x), jb, jax.tree_util.tree_map(jnp.asarray, noises))
        assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("sweep", ["forward", "symmetric"])
def test_gibbs_lrc_invariance(sweep):
    op, f, _, _ = _posterior(grid=(6, 8, 8), radii=(0.2, 0.25, 0.3))
    assert op.cols.windowed
    dense = lrc.LRCOperator(op.base, op.B, op.sigma_inv)
    for o in (op, dense):
        smp = GibbsSampler.create(o, omega=1.0, sweep=sweep)
        for rhs in (f, None):
            mean_err, cov_err = invariance_error(smp, o, rhs)
            assert mean_err < 1e-10 and cov_err < 1e-10, (mean_err, cov_err)


@pytest.fixture
def draws_off(monkeypatch):
    """The keyed Gibbs step with every draw switched off: the sweep
    kernels' noise and the low-rank draw w."""
    for name in ("fused_rb_gibbs_sweep_fd", "fused_rb_gibbs_sweep"):
        monkeypatch.setattr(gibbs, name, functools.partial(getattr(rb_gibbs, name), with_noise=False))
    monkeypatch.setattr(gibbs, "_lowrank_draw", lambda key, scale, n: scale.new_zeros((n, scale.shape[0])))


@pytest.mark.parametrize("sweep", ["forward", "symmetric"])
def test_keyed_lrc_gibbs_without_noise_is_the_explicit_step(draws_off, sweep):
    op, f, jop, jf = _posterior(F32)
    smp = GibbsSampler.create(op, omega=1.0, sweep=sweep)
    assert smp.has_kernel and smp.is_lrc
    jsmp = JaxGibbsSampler.create(jop, omega=1.0, sweep=sweep, impl="lax")
    x = np.random.RandomState(9).randn(*GRID).astype(np.float32)
    zeros = jax.tree_util.tree_map(jnp.asarray, _zeros(smp.noise_shapes()))
    for tb, jb in ((f, jf), (None, None)):
        _, got = smp.step(5, torch.from_numpy(x), tb)
        assert _rel(got, jsmp.step_with_noise(jnp.asarray(x), jb, zeros)) < 1e-5


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_woodbury_matches_jax(solver):
    op, f, jop, jf = _posterior(grid=(6, 8, 10), kappa=3.0)
    jchol = JaxCholeskySampler.create(jop.base)
    chol = convert.cholesky_sampler(np.asarray(jchol.L), np.asarray(jchol.Li), op.grid_shape, DEV)
    smp = WoodburySampler.create(op, chol, solver=solver)
    jsmp = JaxWoodburySampler.create(jop, jchol, solver=solver)
    assert _rel(smp.G, jsmp.G) < (1e-12 if solver == "dense" else 1e-8)
    if solver == "cg":  # the CG columns against JAX's CG itself
        cols = woodbury._solve_columns_cg(op.base, op.B)
        assert _rel(cols, jax_woodbury._solve_columns_cg(jop.base, jop.B)) < 1e-8
    rs = np.random.RandomState(2)
    x = rs.randn(*op.grid_shape)
    noises = _numpy_noises(smp.noise_shapes(), rs)
    got = smp.step_with_noise(torch.from_numpy(x), f, convert.tree(noises, DEV))
    want = jsmp.step_with_noise(jnp.asarray(x), jf, jax.tree_util.tree_map(jnp.asarray, noises))
    assert _rel(got, want) < 1e-10
    # the factors carried across give the same step
    same = convert.woodbury_sampler(chol, np.asarray(jsmp.B), np.asarray(jsmp.sqrt_sigma_inv),
                                    np.asarray(jsmp.G), DEV)
    assert _rel(same.step_with_noise(torch.from_numpy(x), f, convert.tree(noises, DEV)), want) < 1e-12
    # exact prior sampler inside: the posterior is invariant
    mean_err, cov_err = invariance_error(smp, op, f)
    assert mean_err < 1e-10 and cov_err < 1e-10


class _GraphLike:
    """Stands in for an operator that is neither a stencil nor a graph."""

    grid_shape = (10,)
    dtype = F64


def test_lrc_operators_are_taken_and_graph_operators_refused():
    """LRC operators over stencils and over graph operators are taken
    (graph Gibbs, the aggregation hierarchy); an operator that is neither
    is refused with a TypeError."""
    from parmgmc_tpu_torch.models import mesh
    from parmgmc_tpu_torch.operators.graph import GraphOperator, from_csr

    op, _, _, _ = _posterior(F32)
    assert GibbsSampler.create(op).is_lrc
    smp = MGMCSampler.create(op, n_pre=1, n_post=0, coarsest_size=32, coarsening="aggregate")
    assert smp._lrc_chain_eligible() and all(isinstance(o, lrc.LRCOperator) for o in smp.ops)
    g = from_csr(mesh.matern_precision_mesh(*mesh.unit_square_mesh(6), 2.0), device=DEV)
    glrc = lrc.LRCOperator(g, torch.ones((g.n, 1), dtype=F64), torch.ones(1, dtype=F64))
    assert GibbsSampler.create(glrc).is_lrc and isinstance(GibbsSampler.create(g).base, GraphOperator)
    gsmp = MGMCSampler.create(glrc, coarsest_size=12)
    assert gsmp.n_levels >= 2 and all(isinstance(o, lrc.LRCOperator) for o in gsmp.ops)
    with pytest.raises(TypeError, match="stencil or graph"):
        GibbsSampler.create(_GraphLike())
    with pytest.raises(TypeError, match="stencil or graph"):
        MGMCSampler.create(_GraphLike(), coarsening="aggregate")
    with pytest.raises(TypeError, match="stencil or graph"):
        mgmc.build_hierarchy(lrc.LRCOperator(_GraphLike(), op.B, op.sigma_inv))
