"""The port's sharded MGMC path (``parmgmc_tpu_torch.parallel.fused``) and
its kernels' global-row arguments against the JAX package (CPU).

The JAX side runs as its own tests run it (``tests/test_kernels.py``,
``tests/test_sharded_fused.py``): the Pallas kernels in interpret mode
with the noise off, the sharded step on the 8 virtual CPU devices of
``tests/conftest.py`` against the single-device ``step_with_noise`` with
zero noises.  The port runs its kernels' twins on CPU slots.

* the twins of #7, #1 and #3 on halo-extended blocks of a (32, 8, 128)
  grid with ``row_offset``/``n0_global``: the kept rows against the JAX
  kernels on the same blocks (noise off, 1e-5 relative; JAX's own
  bounds for rq), and, with the noise on, bit for bit the full-grid twin
  on the first, an inner and the last block; #8/#9 and #4/#5 the same
  with ``rb_gibbs._PLANE_LIMIT`` patched small (the routes a block past
  the plane limit takes);
* ``sharded_fused_gibbs_sweep`` against JAX's on 8 blocks;
* ``make_sharded_mgmc_step`` (3 levels, 8 blocks, ``min_local=4``) against
  JAX's single-device step with zero noises: prior 1e-5, LRC (k = 2)
  5e-5; with the noise on, the prior step's bits at 1, 2, 4 and 8
  blocks; the LRC step at 1 and 4 blocks to 1e-5; a (32, 8, 256) grid
  on 4 blocks, where level 1 is sharded too (#3 on the path);
* the level rule and the tail's noise shapes against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.kernels.mg_sweep import fused_chain_down_2d_staged as jax_chain_2d_staged
from parmgmc_tpu.kernels.mg_sweep import fused_chain_down_fd as jax_chain
from parmgmc_tpu.kernels.mg_sweep import fused_zero_gibbs_restrict_fd as jax_zero
from parmgmc_tpu.kernels.rb_gibbs import fused_rb_gibbs_sweep_2d as jax_sweep_2d
from parmgmc_tpu.kernels.rb_gibbs import fused_rb_gibbs_sweep_fd as jax_sweep
from parmgmc_tpu.models.obs import make_observation_mats
from parmgmc_tpu.operators.lrc import LRCOperator as JaxLRCOperator
from parmgmc_tpu.operators.stencil import shifted_laplace_fd as jax_shifted_laplace_fd
from parmgmc_tpu.parallel import fused as jax_fused
from parmgmc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu_torch import convert
from parmgmc_tpu_torch.kernels import mg_sweep, rb_gibbs
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.parallel import fused
from parmgmc_tpu_torch.parallel.mesh import exchange_planes, make_mesh, shard_array, unshard
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler, build_hierarchy

# the entry points default to the card; these tests run on the host
DEV = "cpu"
SHAPE = (32, 8, 128)
KAPPA = 1.7
V10 = dict(n_levels=3, n_pre=1, n_post=0, coarsening="aggregate")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _fields(shape=SHAPE, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)


def _fd(shape=SHAPE):
    hinv2 = float((shape[0] - 1) ** 2)
    return (-hinv2,) * 6, KAPPA**2, hinv2


def _block(a, lo, hi, h):
    """Rows lo - h .. hi + h of a, zero rows beyond its ends (the
    halo-extended block of rows lo .. hi)."""
    pad = np.zeros((h, *a.shape[1:]), a.dtype)
    return np.concatenate([pad, a, pad])[lo : hi + 2 * h]


def _rc(rq):
    """JAX's rq with the lane pair-sum closed."""
    n0, n1, n2 = rq.shape
    return np.asarray(rq).reshape(n0, n1, n2 // 2, 2).sum(-1)


BLOCKS = [(0, 8), (16, 24), (24, 32)]  # the first, an inner and the last block


@pytest.mark.parametrize("lo,hi", BLOCKS)
@pytest.mark.parametrize("sweep", ["forward", "backward"])
def test_sweep_twin_offsets_match_jax(lo, hi, sweep):
    """#7 on a 2-plane halo-extended block: kept rows against the JAX
    kernel with the same row_offset / n0_global (noise off)."""
    x, b = _fields()
    coeffs, kappa2, hinv2 = _fd()
    xe, be = _block(x, lo, hi, 2), _block(b, lo, hi, 2)
    kw = dict(row_offset=lo - 2, n0_global=SHAPE[0])
    got = rb_gibbs.fused_rb_gibbs_sweep_fd(
        torch.from_numpy(xe), torch.from_numpy(be), coeffs, kappa2, hinv2, 1.3, 0, 0, 0.0,
        sweep=sweep, with_noise=False, **kw)
    want = jax_sweep(jnp.asarray(xe), jnp.asarray(be), jnp.asarray(coeffs, jnp.float32), kappa2,
                     hinv2, 1.3, 0, 0, noise_mult=0.0, sweep=sweep, interpret=True,
                     with_noise=False, **kw)
    assert _rel(got[2:-2], np.asarray(want)[2:-2]) < 1e-5


@pytest.mark.parametrize("lo,hi", BLOCKS)
def test_chain_twin_offsets_match_jax(lo, hi):
    """#1 on a 4-plane halo-extended block against the JAX kernel (noise
    off; xpy 1e-5, rc 1e-4 as tests/test_kernels.py)."""
    x, b = _fields(seed=1)
    coeffs, kappa2, hinv2 = _fd()
    xe, be = _block(x, lo, hi, 4), _block(b, lo, hi, 4)
    kw = dict(row_offset=lo - 4, n0_global=SHAPE[0])
    xpy, rc = mg_sweep.fused_chain_down_fd(
        torch.from_numpy(xe), torch.from_numpy(be), coeffs, kappa2, hinv2, 1.0, 0, 0,
        with_noise=False, **kw)
    jxpy, jrq = jax_chain(jnp.asarray(xe), jnp.asarray(be), jnp.asarray(coeffs, jnp.float32),
                          kappa2, hinv2, 1.0, 0, 0, sweep="forward", interpret=True,
                          with_noise=False, **kw)
    assert _rel(xpy[4:-4], np.asarray(jxpy)[4:-4]) < 1e-5
    assert _rel(rc[2:-2], _rc(jrq)[2:-2]) < 1e-4


@pytest.mark.parametrize("lo,hi", BLOCKS)
def test_zero_twin_offsets_match_jax(lo, hi):
    """#3 on a 2-plane halo-extended block against the JAX kernel."""
    _, b = _fields(seed=2)
    coeffs, kappa2, hinv2 = _fd()
    be = _block(b, lo, hi, 2)
    kw = dict(row_offset=lo - 2, n0_global=SHAPE[0])
    y, rc = mg_sweep.fused_zero_gibbs_restrict_fd(
        torch.from_numpy(be), coeffs, kappa2, hinv2, 1.0, 0, 0, with_noise=False, **kw)
    jy, jrq = jax_zero(jnp.asarray(be), jnp.asarray(coeffs, jnp.float32), kappa2, hinv2, 1.0, 0,
                       0, sweep="forward", interpret=True, with_noise=False, **kw)
    assert _rel(y[2:-2], np.asarray(jy)[2:-2]) < 1e-5
    assert _rel(rc[1:-1], _rc(jrq)[1:-1]) < 1e-4


def _sweep_call(name, x, b, coeffs, kappa2, hinv2, **kw):
    if name == "rb_gibbs_fd":
        return rb_gibbs.fused_rb_gibbs_sweep_fd(x, b, coeffs, kappa2, hinv2, 1.2, 11, 5, 0.7,
                                                sweep="backward", **kw)
    fn = {"rb_gibbs_2d": rb_gibbs.fused_rb_gibbs_sweep_2d,
          "rb_gibbs_2d_staged": rb_gibbs.fused_rb_gibbs_sweep_2d_staged}[name]
    args = (x, b, None) if name == "rb_gibbs_2d" else (x, b)
    return fn(*args, coeffs, 1.2, 11, 5, 0.7, sweep="backward", fd_params=(kappa2, hinv2), **kw)


def _chain_call(name, x, b, coeffs, kappa2, hinv2, **kw):
    if name == "zero_restrict":
        return mg_sweep.fused_zero_gibbs_restrict_fd(b, coeffs, kappa2, hinv2, 1.1, 3, 9, **kw)
    fn = {"chain_down": mg_sweep.fused_chain_down_fd, "chain_2d": mg_sweep.fused_chain_down_2d,
          "chain_2d_staged": mg_sweep.fused_chain_down_2d_staged}[name]
    return fn(x, b, coeffs, kappa2, hinv2, 1.1, 3, 9, **kw)


@pytest.mark.parametrize("lo,hi", BLOCKS)
@pytest.mark.parametrize("name", ["rb_gibbs_fd", "rb_gibbs_2d", "rb_gibbs_2d_staged",
                                  "chain_down", "chain_2d", "chain_2d_staged", "zero_restrict"])
def test_twins_on_blocks_equal_full_grid_bitwise(name, lo, hi, monkeypatch):
    """With the noise on, every wrapper's twin on a halo-extended block
    gives the full-grid twin's rows bit for bit: the first, an inner and
    the last block.  The #7 wrapper also runs with the plane limit below
    the plane (its route to #8 and #9 forwards the two arguments)."""
    x, b = (torch.from_numpy(a) for a in _fields(seed=3))
    coeffs, kappa2, hinv2 = _fd()
    sweep = name.startswith("rb_gibbs")
    h = 2 if sweep or name == "zero_restrict" else 4
    xe, be = (torch.from_numpy(_block(a.numpy(), lo, hi, h)) for a in (x, b))
    call = _sweep_call if sweep else _chain_call
    full = call(name, x, b, coeffs, kappa2, hinv2)
    kw = dict(row_offset=lo - h, n0_global=SHAPE[0])
    blk = call(name, xe, be, coeffs, kappa2, hinv2, **kw)
    if sweep:
        assert torch.equal(blk[h:-h], full[lo:hi])
        if name == "rb_gibbs_fd":
            monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 8 * 64)
            assert torch.equal(call(name, xe, be, coeffs, kappa2, hinv2, **kw)[h:-h], full[lo:hi])
    else:
        assert torch.equal(blk[0][h:-h], full[0][lo:hi])
        assert torch.equal(blk[1][h // 2 : -h // 2], full[1][lo // 2 : hi // 2])


def test_large_plane_routes_match_jax(monkeypatch):
    """#8 and #4/#5 on blocks, the plane limit patched below the plane:
    the #7 wrapper's route (#8, #9) and the sharded chain's (#4) against
    the JAX 2D kernels on the same blocks (noise off; tests/test_kernels.py
    shapes and bounds)."""
    monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 16 * 64)
    shape = (16, 32, 128)
    x, b = _fields(shape, seed=4)
    coeffs, kappa2, hinv2 = _fd(shape)
    xe, be = x[6:16], b[6:16]  # rows 8 .. 16 with a 2-row halo (the last block)
    kw = dict(row_offset=6, n0_global=16)
    got = rb_gibbs.fused_rb_gibbs_sweep_fd(torch.from_numpy(xe), torch.from_numpy(be), coeffs,
                                           kappa2, hinv2, 1.0, 0, 0, 0.0, with_noise=False, **kw)
    fd = jnp.asarray([kappa2, hinv2], jnp.float32)
    want = jax_sweep_2d(jnp.asarray(xe), jnp.asarray(be), None, jnp.asarray(coeffs, jnp.float32),
                        1.0, 0, 0, noise_mult=0.0, sweep="forward", tile2d=(2, 8),
                        interpret=True, with_noise=False, fd_params=fd, **kw)
    assert _rel(got[2:], np.asarray(want)[2:]) < 1e-5

    shape = (32, 32, 128)
    x, b = _fields(shape, seed=5)
    coeffs, kappa2, hinv2 = _fd(shape)
    # rows 16 .. 32 of 2 blocks through the sharded chain down-phase (#4)
    p = dict(coeffs=coeffs, kappa2=kappa2, hinv2=hinv2, omega=1.0, sweep="forward",
             n0_global=32)
    xs = [torch.from_numpy(x[:16].copy()), torch.from_numpy(x[16:].copy())]
    bs = [torch.from_numpy(b[:16].copy()), torch.from_numpy(b[16:].copy())]
    xpy, rc = fused._sharded_chain_down(xs, bs, p, 0, 0, False)
    jxpy, jrq = jax_chain_2d_staged(jnp.asarray(x[12:32]), jnp.asarray(b[12:32]),
                                    jnp.asarray(coeffs, jnp.float32), kappa2, hinv2, 1.0, 0, 0,
                                    tile2d=(4, 8), sweep="forward", interpret=True,
                                    with_noise=False, row_offset=12, n0_global=32)
    assert _rel(xpy[1], np.asarray(jxpy)[4:]) < 1e-5
    assert _rel(rc[1], _rc(jrq)[2:]) < 1e-4


@pytest.mark.parametrize("sweep", ["forward", "backward"])
def test_sharded_fused_sweep_matches_jax(sweep):
    """JAX's tests/test_sharded_fused.py case: 8 blocks, noise off, against
    the JAX sharded sweep inside shard_map (1e-5), and the port's blocks
    with the noise on bit for bit the port's single-device #7 twin."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    x, b = _fields(seed=6)
    coeffs, kappa2, hinv2 = _fd()
    mesh = make_mesh((8,), devices=[DEV] * 8)
    xs, bs = shard_array(torch.from_numpy(x), mesh), shard_array(torch.from_numpy(b), mesh)
    got = unshard(fused.sharded_fused_gibbs_sweep(xs, bs, coeffs, kappa2, hinv2, 1.3, 0, 0,
                                                  sweep=sweep, noise_mult=0.0, with_noise=False))
    jmesh = jax_make_mesh((8,), axis_names=("x",))
    spec = P("x", None, None)
    body = jax.shard_map(
        lambda xl, bl: jax_fused.sharded_fused_gibbs_sweep(
            xl, bl, jnp.asarray(coeffs, jnp.float32), kappa2, hinv2, 1.3, 0, 0, axis_name="x",
            n0_global=SHAPE[0], sweep=sweep, noise_mult=0.0, interpret=True, with_noise=False),
        mesh=jmesh, in_specs=(spec, spec), out_specs=spec, check_vma=False)
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(jmesh, spec))
    want = jax.jit(body)(put(x), put(b))
    assert _rel(got, want) < 1e-5

    noisy = unshard(fused.sharded_fused_gibbs_sweep(xs, bs, coeffs, kappa2, hinv2, 1.3, 4, 2,
                                                    sweep=sweep))
    full = rb_gibbs.fused_rb_gibbs_sweep_fd(torch.from_numpy(x), torch.from_numpy(b), coeffs,
                                            kappa2, hinv2, 1.3, 4, 2, sweep=sweep)
    assert torch.equal(noisy, full)


def test_exchange_planes_and_local_fd_apply():
    """The 1-plane halos of the blocks give A x block by block: the
    FD operator's apply on the whole grid, to float rounding."""
    x, _ = _fields(seed=7)
    op = shifted_laplace_fd(SHAPE, KAPPA, device=DEV)
    coeffs, kappa2, hinv2 = _fd()
    mesh = make_mesh((4,), devices=[DEV] * 4)
    xs = shard_array(torch.from_numpy(x), mesh)
    halos = exchange_planes(xs, 1)
    ax = [fused._local_fd_apply(xl, lo, hi, coeffs, kappa2, hinv2, 8 * i, SHAPE[0])
          for i, (xl, (lo, hi)) in enumerate(zip(xs, halos))]
    assert _rel(unshard(ax), op.apply(torch.from_numpy(x))) < 1e-6


def _jax_zero_noises(jsmp):
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s, jnp.float32), jsmp.noise_shapes(),
                                  is_leaf=lambda s: isinstance(s, tuple))


def _port_sampler(op, jsmp):
    ops, _ = build_hierarchy(op, n_levels=3, coarsening="aggregate")
    assert [tuple(o.grid_shape) for o in ops] == [tuple(o.grid_shape) for o in jsmp.ops]
    return convert.mgmc_sampler(ops, np.asarray(jsmp.coarse.L), np.asarray(jsmp.coarse.Li),
                                n_pre=1, n_post=0, coarsening="aggregate", device=DEV)


@pytest.mark.parametrize("shape,n_dev", [(SHAPE, 8), ((32, 8, 256), 4)])
def test_sharded_mgmc_step_matches_jax(shape, n_dev):
    """Noise off: the sharded prior step against JAX's single-device
    step_with_noise with zero noises (1e-5).  (32, 8, 128) on 8 blocks
    shards level 0 only, as JAX's test; (32, 8, 256) on 4 blocks shards
    level 1 too (#3's twin on the path)."""
    jsmp = JaxMGMCSampler.create(jax_shifted_laplace_fd(shape, 1.0, dtype=jnp.float32),
                                 impl="fused_fd", **V10)
    smp = _port_sampler(shifted_laplace_fd(shape, 1.0, device=DEV), jsmp)
    mesh = make_mesh((n_dev,), devices=[DEV] * n_dev)
    x, b = _fields(shape, seed=8)
    step = fused.make_sharded_mgmc_step(smp, mesh, min_local=4, with_noise=False)
    _, out = step(5, shard_array(torch.from_numpy(x), mesh), shard_array(torch.from_numpy(b), mesh))
    assert len(out) == n_dev
    ref = jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(b), _jax_zero_noises(jsmp))
    assert _rel(unshard(out), ref) < 1e-5
    n_sh = 1 if shape == SHAPE else 2
    assert fused._tail_shapes(smp, n_sh) == jax_fused._tail_shapes(jsmp, n_sh)
    for l in range(smp.n_levels - 1):
        assert fused._level_shardable(smp, l, n_dev, 4) == jax_fused._level_shardable(
            jsmp, l, n_dev, 4), l


def test_sharded_prior_step_bits_across_blocks():
    """With the noise on, the prior step gives the same bits on 1, 2, 4 and
    8 blocks (a chain of three steps)."""
    smp = MGMCSampler.create(shifted_laplace_fd(SHAPE, 1.0, device=DEV), **V10)
    x, b = (torch.from_numpy(a) for a in _fields(seed=9))
    outs = []
    for n in (1, 2, 4, 8):
        mesh = make_mesh((n,), devices=[DEV] * n)
        step = fused.make_sharded_mgmc_step(smp, mesh, min_local=4)
        key, xs, bs = 17, shard_array(x, mesh), shard_array(b, mesh)
        for _ in range(3):
            key, xs = step(key, xs, bs)
        outs.append(unshard(xs))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.isfinite(outs[0]).all() and not torch.equal(outs[0], x)


def _lrc_problem():
    base = jax_shifted_laplace_fd(SHAPE, 1.0, dtype=jnp.float32)
    B, sigma_inv, f = make_observation_mats(
        SHAPE, 0.05, np.array([[0.3, 0.5, 0.4], [0.7, 0.4, 0.6]]), np.full(2, 0.25),
        obsvals=np.ones(2), dtype=jnp.float32)
    jsmp = JaxMGMCSampler.create(JaxLRCOperator(base=base, B=B, sigma_inv=sigma_inv),
                                 impl="fused_fd", **V10)
    op = convert.lrc_operator(shifted_laplace_fd(SHAPE, 1.0, device=DEV), np.asarray(B),
                              np.asarray(sigma_inv), device=DEV)
    smp = _port_sampler(op, jsmp)
    assert smp.lrc_aux is not None
    return jsmp, smp, np.array(f)


def test_sharded_lrc_step_matches_jax():
    """The posterior step, noise off, on 8 blocks against JAX's
    single-device step_with_noise with zero noises (5e-5: the rank-k sums
    run block by block); with the noise on, 1 and 4 blocks agree to 1e-5."""
    jsmp, smp, f = _lrc_problem()
    x, _ = _fields(seed=10)
    mesh = make_mesh((8,), devices=[DEV] * 8)
    step = fused.make_sharded_mgmc_step(smp, mesh, min_local=4, with_noise=False)
    _, out = step(8, shard_array(torch.from_numpy(x), mesh), shard_array(torch.from_numpy(f), mesh))
    ref = jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(f), _jax_zero_noises(jsmp))
    assert _rel(unshard(out), ref) < 5e-5

    outs = []
    for n in (1, 4):
        mesh = make_mesh((n,), devices=[DEV] * n)
        step = fused.make_sharded_mgmc_step(smp, mesh, min_local=4)
        _, xs = step(3, shard_array(torch.from_numpy(x), mesh), shard_array(torch.from_numpy(f), mesh))
        outs.append(unshard(xs))
    assert _rel(outs[1], outs[0]) < 1e-5


def test_sharded_step_refusals():
    """V(2,2) and a fine level no block rule admits raise."""
    op = shifted_laplace_fd(SHAPE, 1.0, device=DEV)
    mesh = make_mesh((8,), devices=[DEV] * 8)
    v22 = MGMCSampler.create(op, n_levels=3, n_pre=2, n_post=2, coarsening="aggregate")
    with pytest.raises(ValueError, match="V\\(1,0\\)"):
        fused.make_sharded_mgmc_step(v22, mesh)
    smp = MGMCSampler.create(op, **V10)
    with pytest.raises(ValueError, match="not shardable"):
        fused.make_sharded_mgmc_step(smp, mesh, min_local=8)


def _tensor_leaves(obj, seen=None):
    """Every tensor reachable through dataclass fields, tuples, lists and
    dicts of ``obj``."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensor_leaves(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensor_leaves(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensor_leaves(getattr(obj, f.name))


@pytest.mark.parametrize("posterior", [False, True])
def test_tail_copy_reaches_every_tensor(posterior):
    """The replicated tail runs once a distinct device on a copy of the
    sampler's levels: the copy holds every tensor on the target device
    (here the meta device) and the same noise shapes."""
    if posterior:
        _, smp, _ = _lrc_problem()
    else:
        smp = MGMCSampler.create(shifted_laplace_fd(SHAPE, 1.0, device=DEV), **V10)
    meta = torch.device("meta")
    moved = fused._to_device(smp, meta)
    leaves = list(_tensor_leaves(moved))
    assert leaves and all(t.device == meta for t in leaves)
    assert len(leaves) == len(list(_tensor_leaves(smp)))
    assert moved.noise_shapes() == smp.noise_shapes()
    assert all(str(o.device) == "meta" for o in moved.ops)
