"""The port's mesh and plain sharded sweeps (``parmgmc_tpu_torch.parallel.
mesh`` and ``.sharded``) against the JAX package (CPU).

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
(as ``tests/test_parallel.py`` runs it); the port's mesh puts its slots on
the host with ``devices=["cpu"] * n``.

* ``level_specs`` and the spec of a leaf against JAX's on a 4-level
  aggregate hierarchy's shapes, for mesh shapes (8,) and (4, 2);
* ``shard_array``/``unshard`` round trip, ``exchange_planes`` (zeros at
  the chain ends), ``psum`` (the same bits on every slot), ``all_gather``;
* ``make_mesh`` without ``devices=`` raises where the host has too few
  cards;
* ``sharded_gibbs_sweep`` (float64): exact mode against JAX
  ``samplers/sor.py::sor_sweep`` (1e-12), frozen mode against JAX's
  ``sharded_gibbs_sweep(halo_mode="frozen")`` inside ``shard_map``
  (1e-12), 2D and 3D; ``make_sharded_gibbs_step`` against its own sweep on
  b + scale eta with eta from the same key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.operators.stencil import shifted_laplace_fd as jax_shifted_laplace_fd
from parmgmc_tpu.parallel import mesh as jax_mesh
from parmgmc_tpu.parallel.sharded import sharded_gibbs_sweep as jax_sharded_gibbs_sweep
from parmgmc_tpu.samplers.sor import sor_sweep as jax_sor_sweep
from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.kernels._twin import noise_factor
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.parallel import mesh, sharded

# the entry points default to the card; these tests run on the host
DEV = "cpu"
F64 = torch.float64

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


# a 4-level aggregate hierarchy's grid shapes
HIERARCHY = [(64, 32, 128), (32, 16, 64), (16, 8, 32), (8, 4, 16)]


@pytest.mark.parametrize("shape", [(8,), (4, 2)])
@pytest.mark.parametrize("min_local", [2, 4, 8])
def test_level_specs_match_jax(shape, min_local):
    m = mesh.make_mesh(shape, devices=[DEV] * 8)
    jm = jax_mesh.make_mesh(shape)
    assert m.shape == dict(jm.shape) and m.axis_names == tuple(jm.axis_names)
    specs = mesh.level_specs(HIERARCHY, m, min_local)
    jspecs = jax_mesh.level_specs(HIERARCHY, jm, min_local)
    assert specs == [(g, tuple(a)) for g, a in jspecs]
    for leaf in [(64, 32, 128), (64, 32, 128, 5), (16, 8, 32), (8, 4, 16), (7,)]:
        assert mesh._spec_for_shape(leaf, specs) == tuple(jax_mesh._spec_for_shape(leaf, jspecs))


def test_shard_unshard_round_trip_and_slots():
    m = mesh.make_mesh((4, 2), devices=[DEV] * 8)
    assert len(m.slots()) == 4 and len(m.slots("y")) == 2
    x = torch.arange(8 * 3 * 5, dtype=F64).reshape(8, 3, 5)
    for axis, name in ((0, "x"), (2, "y")):
        n = m.shape[name]
        if x.shape[axis] % n:
            continue
        blocks = mesh.shard_array(x, m, axis=axis, axis_name=name)
        assert len(blocks) == n and all(b.is_contiguous() for b in blocks)
        assert torch.equal(mesh.unshard(blocks, axis=axis), x)
    blocks = mesh.shard_array(x, m)
    blocks[0][0, 0, 0] = -1.0  # blocks own their memory
    assert x[0, 0, 0] == 0.0
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_array(torch.zeros(6, 2), m)


def test_exchange_psum_gather():
    m = mesh.make_mesh((4,), devices=[DEV] * 4)
    x = torch.from_numpy(np.random.RandomState(0).randn(16, 3, 2))
    blocks = mesh.shard_array(x, m)
    for h in (1, 2, 4):
        halos = mesh.exchange_planes(blocks, h)
        assert torch.equal(halos[0][0], torch.zeros(h, 3, 2))
        assert torch.equal(halos[-1][1], torch.zeros(h, 3, 2))
        for i in range(1, 4):
            assert torch.equal(halos[i][0], x[4 * i - h : 4 * i])
            assert torch.equal(halos[i - 1][1], x[4 * i : 4 * i + h])
    parts = [b.sum(dim=(0, 1)) for b in blocks]
    sums = mesh.psum(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(torch.equal(s, want) for s in sums)
    gathered = mesh.all_gather(blocks)
    assert all(torch.equal(g, x) for g in gathered)


def test_make_mesh_needs_distinct_devices():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="distinct CUDA devices"):
        mesh.make_mesh((have + 1,))
    with pytest.raises(ValueError, match="got 2 devices"):
        mesh.make_mesh((4,), devices=[DEV] * 2)
    m = mesh.make_mesh((2, 2), devices=[DEV] * 4)
    assert m.devices.size == 4 and m.shape == {"x": 2, "y": 2}


def _problem(shape, kappa, seed=0):
    op = shifted_laplace_fd(shape, kappa, F64, device=DEV)
    jop = jax_shifted_laplace_fd(shape, kappa, dtype=jnp.float64)
    rs = np.random.RandomState(seed)
    x, b = rs.randn(*shape), rs.randn(*shape)
    d = op.ndim
    coeffs = torch.stack([dict(zip(op.offsets, op.coeffs))[o] for o in _order(d)])
    return op, jop, x, b, coeffs


def _order(d):
    out = []
    for ax in range(d):
        for s in (-1, 1):
            off = [0] * d
            off[ax] = s
            out.append(tuple(off))
    return out


@pytest.mark.parametrize("shape", [(32, 16), (16, 6, 5)])
@pytest.mark.parametrize("sweep", ["forward", "backward"])
def test_exact_mode_matches_jax_sor_sweep(shape, sweep):
    """Exact halos: the single-device multicolour sweep (JAX sor_sweep)."""
    op, jop, x, b, coeffs = _problem(shape, 3.0)
    m = mesh.make_mesh((8,), devices=[DEV] * 8)
    split = lambda a: mesh.shard_array(a, m)
    out = sharded.sharded_gibbs_sweep(split(torch.from_numpy(x)), split(torch.from_numpy(b)),
                                      split(op.diag), [coeffs] * 8, 1.3, sweep=sweep)
    ref = jax_sor_sweep(jop, jnp.asarray(b), jnp.asarray(x), 1.3, sweep)
    np.testing.assert_allclose(mesh.unshard(out).numpy(), np.asarray(ref), atol=1e-12)


@pytest.mark.parametrize("shape", [(32, 16), (16, 6, 5)])
def test_frozen_mode_matches_jax(shape):
    """Frozen halos against JAX's frozen sweep inside shard_map, and not
    the exact sweep (the halos are stale across blocks)."""
    from jax.sharding import PartitionSpec as P

    op, jop, x, b, coeffs = _problem(shape, 3.0, seed=1)
    m = mesh.make_mesh((8,), devices=[DEV] * 8)
    split = lambda a: mesh.shard_array(a, m)
    out = mesh.unshard(sharded.sharded_gibbs_sweep(
        split(torch.from_numpy(x)), split(torch.from_numpy(b)), split(op.diag), [coeffs] * 8, 1.3,
        halo_mode="frozen"))
    jm = jax_mesh.make_mesh((8,), axis_names=("x",))
    f = jax.jit(jax.shard_map(
        lambda xx, bb, dd: jax_sharded_gibbs_sweep(
            xx, bb, dd, jnp.asarray(coeffs.numpy()), 1.3, "x", sweep="forward", halo_mode="frozen"),
        mesh=jm, in_specs=(P("x"), P("x"), P("x")), out_specs=P("x")))
    ref = f(jnp.asarray(x), jnp.asarray(b), jop.diag)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12)
    exact = jax_sor_sweep(jop, jnp.asarray(b), jnp.asarray(x), 1.3, "forward")
    assert np.abs(out.numpy() - np.asarray(exact)).max() > 1e-6


@pytest.mark.parametrize("halo_mode", ["exact", "frozen"])
def test_sharded_gibbs_step_is_its_sweep_on_noisy_rhs(halo_mode):
    """make_sharded_gibbs_step (symmetric): each half-sweep is the sharded
    sweep on b + sqrt((2 - omega)/omega) sqrt(D) eta, eta drawn on the
    whole grid from the half's key."""
    op, _, x, b, coeffs = _problem((32, 16), 2.0, seed=2)
    m = mesh.make_mesh((4,), devices=[DEV] * 4)
    split = lambda a: mesh.shard_array(a, m)
    step = sharded.make_sharded_gibbs_step(op, m, omega=1.2, sweep="symmetric",
                                           halo_mode=halo_mode)
    xs, bs = split(torch.from_numpy(x)), split(torch.from_numpy(b))
    key, out = step(11, xs, bs)
    k, want = 11, xs
    scale = noise_factor(1.2, F64) * torch.sqrt(op.diag)
    for h in ("forward", "backward"):
        k, sub = keys.split(k)
        eta = torch.randn(op.grid_shape, generator=keys.generator(sub, DEV), dtype=F64)
        want = sharded.sharded_gibbs_sweep(want, split(torch.from_numpy(b) + scale * eta),
                                           split(op.diag), [coeffs] * 4, 1.2, sweep=h,
                                           halo_mode=halo_mode)
    assert key == k
    assert torch.equal(mesh.unshard(out), mesh.unshard(want))
