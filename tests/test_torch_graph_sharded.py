"""The port's row-partitioned mesh sampling (``parmgmc_tpu_torch.parallel.
graph_sharded``) against the JAX package's (CPU).

The JAX side runs ``parmgmc_tpu.parallel.graph_sharded`` inside
``shard_map`` on the 8 virtual CPU devices of ``tests/conftest.py``; the
port's slots are 8 slots on the host (``devices=["cpu"] * 8``).  The
problem is the JAX tests' fixture, the Matérn precision (kappa 7) of
``unit_square_mesh(12)`` (169 nodes, a 3-level hierarchy), float64:

* the partition, array for array, in both ghost modes;
* the layout round trip, in the per-slot and the stacked form;
* ``sharded_apply`` and each sweep direction against JAX's (1e-12), the
  ghost modes against each other;
* the deterministic sharded MGMC step, prior and LRC posterior, against
  JAX's sharded step with ``with_noise=False`` (1e-11) and the port's
  unsharded ``step_with_noise`` with zero noises;
* the chain-major step's shape, distinct chains; a keyed Gibbs chain's
  mean against A^{-1} b (the JAX test's rel < 0.05, through 32 chains).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parmgmc_tpu.operators.graph import from_csr as jax_from_csr
from parmgmc_tpu.operators.lrc import LRCOperator as JaxLRCOperator
from parmgmc_tpu.parallel import graph_sharded as jgs
from parmgmc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu_torch.models.mesh import matern_precision_mesh, unit_square_mesh
from parmgmc_tpu_torch.operators.graph import from_csr
from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.parallel import graph_sharded as gs
from parmgmc_tpu_torch.parallel.mesh import make_mesh
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

# the entry points default to the card; these tests run on the host
DEV = "cpu"
S = 8

pytestmark = pytest.mark.skipif(len(jax.devices()) < S, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    pts, cells = unit_square_mesh(12)
    A = matern_precision_mesh(pts, cells, 7.0)
    op = from_csr(A, device=DEV)
    jop = jax_from_csr(A, dtype=jnp.float64)
    mesh = make_mesh((S,), devices=[DEV] * S)
    jmesh = jax_make_mesh((S,), axis_names=("x",))
    return op, jop, pts, mesh, jmesh


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_map(jmesh, spec, fn, *args):
    """fn(spec_block, *arg_blocks) on JAX's mesh (each argument stacked
    (S, L, ...))."""
    ps = P("x")
    f = jax.jit(jax.shard_map(
        lambda sp, *a: fn(sp, *(v[0] for v in a))[None], mesh=jmesh,
        in_specs=(jax.tree_util.tree_map(lambda _: ps, spec),) + (ps,) * len(args),
        out_specs=ps, check_vma=False))
    return f(spec, *args)


@pytest.mark.parametrize("mode", ["neighbor", "allgather"])
def test_partition_matches_jax(problem, mode):
    op, jop, pts, _, _ = problem
    sp = gs.partition_graph_operator(op, S, coords=pts, ghost_mode=mode)
    jsp = jgs.partition_graph_operator(jop, S, coords=pts, ghost_mode=mode)
    for name in ("vals", "cols", "diag", "export_idx", "own_gid", "own_mask"):
        np.testing.assert_array_equal(getattr(sp, name), np.asarray(getattr(jsp, name)), err_msg=name)
    assert (sp.color_starts, sp.bmax, sp.n_local, sp.nbr_shifts) == (
        jsp.color_starts, jsp.bmax, jsp.n_local, tuple(jsp.nbr_shifts))
    assert (sp.ncolors, sp.ghost_rows_received) == (jsp.ncolors, jsp.ghost_rows_received)
    assert all(torch.equal(sl.cols, _t(sp.cols[s]).long()) for s, sl in enumerate(sp.slots))
    # without coordinates the cut follows the original node order, as in JAX
    np.testing.assert_array_equal(gs.partition_graph_operator(op, S).own_gid,
                                  np.asarray(jgs.partition_graph_operator(jop, S).own_gid))


def test_layout_round_trip(problem):
    op, jop, pts, _, _ = problem
    sp = gs.partition_graph_operator(op, S, coords=pts)
    jsp = jgs.partition_graph_operator(jop, S, coords=pts)
    v = np.random.default_rng(0).standard_normal((op.n, 3))
    blocks = gs.to_local(sp, _t(v))
    assert len(blocks) == S and blocks[0].shape == (sp.n_local, 3)
    assert torch.equal(gs.to_global(sp, blocks, op.n), _t(v))
    stacked = gs.to_local(sp, _t(v), stacked=True)
    np.testing.assert_array_equal(stacked.numpy(), np.asarray(jgs.to_local(jsp, jnp.asarray(v))))
    assert torch.equal(gs.to_global(sp, stacked, op.n), _t(v))
    assert float(sp.own_mask.sum()) == op.n
    np.testing.assert_array_equal(gs.rows_to_local(sp, _t(v), stacked=True).numpy(),
                                  np.asarray(jgs.rows_to_local(jsp, jnp.asarray(v))))


def test_apply_and_sweeps_match_jax(problem):
    op, jop, pts, _, jmesh = problem
    sp = gs.partition_graph_operator(op, S, coords=pts)
    jsp = jgs.partition_graph_operator(jop, S, coords=pts)
    rng = np.random.default_rng(2)
    x, b = rng.standard_normal(op.n), rng.standard_normal(op.n)
    jx, jb = jgs.to_local(jsp, jnp.asarray(x)), jgs.to_local(jsp, jnp.asarray(b))
    got = gs.to_global(sp, gs.sharded_apply(sp, gs.to_local(sp, _t(x))), op.n)
    want = jgs.to_global(jsp, _jax_map(jmesh, jsp, lambda s, v: jgs.sharded_apply(s, v, "x"), jx), op.n)
    assert float((got - _t(want)).abs().max()) < 1e-12
    for sweep in ("forward", "backward", "symmetric"):
        got = gs.to_global(sp, gs.sharded_sor_sweep(sp, gs.to_local(sp, _t(b)), gs.to_local(sp, _t(x)), 1.3,
                                                    sweep), op.n)
        want = jgs.to_global(jsp, _jax_map(
            jmesh, jsp, lambda s, bb, xx, sw=sweep: jgs.sharded_sor_sweep(s, bb, xx, 1.3, "x", sw), jb, jx), op.n)
        assert float((got - _t(want)).abs().max()) < 1e-12, sweep
        assert float((got - op.sor_sweep(_t(b), _t(x), 1.3, sweep)).abs().max()) < 1e-12, sweep


def test_ghost_modes_agree(problem):
    op, _, pts, _, _ = problem
    rng = np.random.default_rng(7)
    x, b = _t(rng.standard_normal((op.n, 2))), _t(rng.standard_normal(op.n))
    outs = {}
    for mode in ("neighbor", "allgather"):
        sp = gs.partition_graph_operator(op, S, coords=pts, ghost_mode=mode)
        outs[mode] = gs.to_global(sp, gs.sharded_sor_sweep(sp, gs.to_local(sp, b), gs.to_local(sp, x), 1.0,
                                                           "symmetric"), op.n)
        if mode == "neighbor":  # only near ring neighbours talk, never all S - 1 offsets
            assert len(sp.nbr_shifts) <= 4 and sp.ghost_rows_received < S * sp.bmax
    want = op.sor_sweep(b, x, 1.0, "symmetric")
    assert float((outs["neighbor"] - want).abs().max()) < 1e-12
    assert float((outs["allgather"] - want).abs().max()) < 1e-12


def _lrc_samplers(op, jop, k=3, seed=11):
    """The JAX test's synthetic localized LRC on the mesh (internal order)."""
    rng = np.random.default_rng(seed)
    B = np.zeros((op.n, k))
    for j in range(k):
        sup = rng.choice(op.n, size=7, replace=False)
        B[sup, j] = rng.standard_normal(7)
    si = rng.uniform(0.5, 2.0, k)
    smp = MGMCSampler.create(LRCOperator(base=op, B=_t(B), sigma_inv=_t(si)), coarsest_size=16)
    jsmp = JaxMGMCSampler.create(JaxLRCOperator(base=jop, B=jnp.asarray(B), sigma_inv=jnp.asarray(si)),
                                 coarsest_size=16)
    return smp, jsmp


def _zeros(shapes):
    if isinstance(shapes, tuple):
        return torch.zeros(shapes, dtype=torch.float64)
    if isinstance(shapes, dict):
        return {k: _zeros(v) for k, v in shapes.items()}
    return [_zeros(v) for v in shapes]


@pytest.mark.parametrize("posterior", [False, True], ids=["prior", "lrc"])
def test_sharded_mgmc_deterministic_matches_jax(problem, posterior):
    op, jop, pts, mesh, jmesh = problem
    if posterior:
        smp, jsmp = _lrc_samplers(op, jop)
    else:
        smp, jsmp = MGMCSampler.create(op, coarsest_size=16), JaxMGMCSampler.create(jop, coarsest_size=16)
    assert smp.n_levels >= 3
    step, spec, layout = gs.make_sharded_graph_mgmc_step(smp, mesh, coords=pts, with_noise=False)
    jstep, jspec, jsh = jgs.make_sharded_graph_mgmc_step(jsmp, jmesh, coords=pts, with_noise=False)
    rng = np.random.default_rng(4 if posterior else 3)
    x, b = rng.standard_normal(op.n), rng.standard_normal(op.n)
    key, out = step(0, layout.shard(_t(x)), layout.shard(_t(b)))
    got = layout.unshard(out)
    _, jout = jstep(jax.random.PRNGKey(0), jax.device_put(jgs.to_local(jspec, jnp.asarray(x)), jsh),
                    jax.device_put(jgs.to_local(jspec, jnp.asarray(b)), jsh))
    want = jgs.to_global(jspec, jout, op.n)
    assert float((got - _t(want)).abs().max()) < 1e-11
    ref = smp.step_with_noise(_t(x), _t(b), _zeros(smp.noise_shapes()))
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-10


def test_sharded_mgmc_multichain(problem):
    """Domain decomposition composes with the trailing chain axis."""
    op, _, pts, mesh, _ = problem
    smp = MGMCSampler.create(op, coarsest_size=16)
    C = 3
    step, spec, layout = gs.make_sharded_graph_mgmc_step(smp, mesh, coords=pts, n_chains=C)
    xs = [torch.zeros((spec.n_local, C), dtype=torch.float64) for _ in range(S)]
    key, out = step(9, xs, layout.shard(torch.ones(op.n, dtype=torch.float64)))
    assert key != 9 and all(o.shape == (spec.n_local, C) for o in out)
    g = layout.unshard(out)
    assert bool(torch.isfinite(g).all()) and float((g[:, 0] - g[:, 1]).abs().max()) > 0


def test_sharded_gibbs_chain_mean(problem):
    """Keyed sharded Gibbs chains: the mean of 32 chain-major chains over
    400 steps after 100 converges to A^{-1} b (the JAX test's gate)."""
    op, _, pts, mesh, _ = problem
    C, burn, n = 32, 100, 400
    step, spec, layout = gs.make_sharded_graph_gibbs_step(op, mesh, coords=pts, n_chains=C)
    bs = layout.shard(torch.ones(op.n, dtype=torch.float64))
    xs = [torch.zeros((spec.n_local, C), dtype=torch.float64) for _ in range(S)]
    key = 5
    for _ in range(burn):
        key, xs = step(key, xs, bs)
    acc = [torch.zeros_like(x) for x in xs]
    for _ in range(n):
        key, xs = step(key, xs, bs)
        acc = [a + x for a, x in zip(acc, xs)]
    got = layout.unshard(acc).mean(dim=1).numpy() / n
    ex = np.linalg.solve(op.to_dense().numpy(), np.ones(op.n))
    assert np.linalg.norm(got - ex) / np.linalg.norm(ex) < 0.05
