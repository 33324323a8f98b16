"""The port's kernel twins against the JAX kernels (CPU).

The chain twin is held against the Pallas chain kernel in interpret mode
(noise off, the tolerances of tests/test_kernels.py: xpy 1e-5, rc 1e-4,
relative max-norm); the tail twin against the JAX ``tail_down_reference``
with the noise off AND on (1e-5: the two share the hash, the Box-Muller
map and the sine polynomial; only log/sqrt round differently); the noise
hash bit for bit against the JAX ``_mix``/``_eta_hash``.  Inputs are made
with numpy from a seed and handed to both packages.

The CUDA kernels themselves are held against these twins on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.kernels.mg_sweep import fused_chain_down_fd as jax_chain
from parmgmc_tpu.kernels.mg_tail import _eta_hash as jax_eta_hash
from parmgmc_tpu.kernels.mg_tail import tail_down_reference as jax_tail_reference
from parmgmc_tpu.kernels.rb_gibbs import _mix as jax_mix
from parmgmc_tpu.kernels.rb_gibbs import _sincos2pi as jax_sincos2pi
from parmgmc_tpu_torch import convert, kernels
from parmgmc_tpu_torch.kernels import _noise
from parmgmc_tpu_torch.kernels.mg_sweep import (
    fused_chain_down_fd,
    fused_chain_down_fd_reference,
)
from parmgmc_tpu_torch.kernels.mg_tail import fused_tail_down, tail_down_reference


# the entry points default to the card; these tests run on the host
DEV = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_mix_and_hash_bits_match_jax():
    rs = np.random.RandomState(0)
    a = rs.randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    b = rs.randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax_mix(jnp.asarray(a), jnp.asarray(b)))
    got = _noise.mix(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    assert (got.numpy().astype(np.uint32) == want).all()
    # scalar (host) path of the same function
    assert _noise.mix(int(a[0]), int(b[0])) == int(want[0])

    idx = np.arange(0, 5000, 7, dtype=np.uint32)
    seed, step = 1234567, 2**31 - 5
    for li in (0, 3):
        su, stepu = jnp.uint32(seed), jnp.uint32(step)
        h1 = jax_mix(jax_mix(jax_mix(su, stepu), jnp.uint32(0xA511E9B3) + jnp.uint32(li)),
                     jnp.asarray(idx))
        h2 = jax_mix(h1, jnp.uint32(0x63D83595))
        prefix = _noise.hash_prefix(seed, step, _noise.TAIL_DOMAIN + li)
        g1, g2 = _noise.hash_bits(prefix, torch.from_numpy(idx.astype(np.int64)))
        assert (g1.numpy().astype(np.uint32) == np.asarray(h1)).all()
        assert (g2.numpy().astype(np.uint32) == np.asarray(h2)).all()
        bc = lambda v, dt: jax.lax.bitcast_convert_type(v, dt)
        eta_j = np.asarray(jax_eta_hash(su, stepu, jnp.uint32(li), jnp.asarray(idx), bc))
        eta_t = _noise.eta_hash(prefix, torch.from_numpy(idx.astype(np.int64))).numpy()
        assert eta_t.dtype == np.float32
        assert np.abs(eta_t - eta_j).max() < 1e-5 * np.abs(eta_j).max()


def test_sincos2pi_matches_jax():
    t = np.random.RandomState(1).rand(10000).astype(np.float32)
    cj, sj = (np.asarray(v) for v in jax_sincos2pi(jnp.asarray(t)))
    ct, st = (v.numpy() for v in _noise.sincos2pi(torch.from_numpy(t)))
    assert np.abs(ct - cj).max() < 1e-6 and np.abs(st - sj).max() < 1e-6
    assert np.abs(ct - np.cos(2 * np.pi * t)).max() < 1e-6


@pytest.mark.parametrize("shape", [(8, 8, 128), (16, 16, 128)])
@pytest.mark.parametrize("sweep", ["forward", "backward"])
def test_chain_twin_matches_jax_kernel(shape, sweep):
    rs = np.random.RandomState(11)
    x = rs.randn(*shape).astype(np.float32)
    b = rs.randn(*shape).astype(np.float32)
    z = rs.randn(*(s // 2 for s in shape)).astype(np.float32)
    zx2 = np.repeat(z, 2, axis=-1)  # the JAX lane-duplicated carry
    assert np.array_equal(convert.deferred_carry_from_jax(zx2, "zx2", DEV).numpy(), z)
    kappa2, hinv2, omega = 1.7**2, float((shape[0] - 1) ** 2), 1.3
    coeffs = [-hinv2] * 6
    args = (kappa2, hinv2, omega, 3, 5)
    m = tuple(s // 2 for s in shape)

    # b given, no carry
    xpy_j, rq_j = jax_chain(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(coeffs, jnp.float32), *args,
        sweep=sweep, interpret=True, with_noise=False,
    )
    rc_j = np.asarray(rq_j).reshape(*m, 2).sum(-1)
    xpy_t, rc_t = fused_chain_down_fd_reference(
        torch.from_numpy(x), torch.from_numpy(b), coeffs, *args, sweep=sweep, with_noise=False
    )
    assert _rel(xpy_t, xpy_j) < 1e-5
    assert _rel(rc_t, rc_j) < 1e-4

    # b=None with the deferred carry and both partial sums
    xpy_j, rq_j, xsum_j, zsum_j = jax_chain(
        jnp.asarray(x), None, jnp.asarray(coeffs, jnp.float32), *args, sweep=sweep,
        interpret=True, with_noise=False, zx2=jnp.asarray(zx2), with_xsum=True,
        with_zsum=True,
    )
    rc_j = np.asarray(rq_j).reshape(*m, 2).sum(-1)
    xpy_t, rc_t, xsum_t, zsum_t = fused_chain_down_fd_reference(
        torch.from_numpy(x), None, coeffs, *args, sweep=sweep, with_noise=False,
        z=torch.from_numpy(z), with_xsum=True, with_zsum=True,
    )
    assert _rel(xpy_t, xpy_j) < 1e-5
    assert _rel(rc_t, rc_j) < 1e-4
    scale = float(np.abs(np.asarray(xpy_j, np.float64)).sum())
    assert abs(float(xsum_t.double().sum()) - float(np.asarray(xsum_j, np.float64).sum())) < 1e-5 * scale
    # the JAX zsum sums the lane-duplicated zx2: twice the compact sum
    zscale = 2 * float(np.abs(z.astype(np.float64)).sum())
    assert abs(2 * float(zsum_t.double().sum()) - float(np.asarray(zsum_j, np.float64).sum())) < 1e-5 * zscale


_TAIL_SHAPES = ((32, 32, 64), (16, 16, 32), (8, 8, 16), (4, 4, 8))


def _tail_inputs():
    bl = np.random.RandomState(0).randn(*_TAIL_SHAPES[0]).astype(np.float32)
    params, (k2, h2) = [], (1.0, float(31**2))
    for _ in range(3):
        params += [1.0, k2, h2]
        k2, h2 = 8 * k2, 4 * h2
    return bl, params


@pytest.mark.parametrize("with_noise", [False, True])
@pytest.mark.parametrize("color0", [0, 1])
def test_tail_twin_matches_jax_reference(with_noise, color0):
    bl, params = _tail_inputs()
    bl_layout = np.repeat(bl, 2, axis=-1)  # the JAX duplicated (n0, S1, 128) layout
    ys_j, rhs_j = jax_tail_reference(
        jnp.asarray(bl_layout), jnp.asarray(params, jnp.float32), 3, 7, color0,
        _TAIL_SHAPES, with_noise=with_noise,
    )
    ys_t, rhs_t = tail_down_reference(
        torch.from_numpy(bl), params, 3, 7, color0, _TAIL_SHAPES, with_noise=with_noise
    )
    S1 = _TAIL_SHAPES[0][1]
    for yj, yt, (n0, n1, n2) in zip(ys_j, ys_t, _TAIL_SHAPES):
        yj = np.asarray(yj)[:, :: S1 // n1, :: 128 // n2]
        assert yt.shape == (n0, n1, n2)
        assert _rel(yt, yj) < 1e-5
    n0, n1, n2 = _TAIL_SHAPES[-1]
    assert _rel(rhs_t, np.asarray(rhs_j)[:, :: S1 // n1, :: 128 // n2]) < 1e-5


def test_wrappers_run_the_twins_on_cpu():
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(8, 8, 32).astype(np.float32))
    z = torch.from_numpy(rs.randn(4, 4, 16).astype(np.float32))
    kernels.reset_launch_counts()
    args = (x, None, [-49.0] * 6, 1.0, 49.0, 1.0, 4, 9)
    kw = dict(z=z, with_xsum=True, with_zsum=True)
    got = fused_chain_down_fd(*args, **kw)
    want = fused_chain_down_fd_reference(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    bl, params = _tail_inputs()
    ys, rhs = fused_tail_down(torch.from_numpy(bl), params, 1, 2, 0, _TAIL_SHAPES)
    ys_r, rhs_r = tail_down_reference(torch.from_numpy(bl), params, 1, 2, 0, _TAIL_SHAPES)
    assert all(torch.equal(a, b) for a, b in zip(ys, ys_r)) and torch.equal(rhs, rhs_r)
    assert all(v == 0 for v in kernels.launch_counts().values())
    # partial sums are one a work item of chain_fd_plan (four 2-plane
    # segments of the one strip) and add up to the totals
    assert got[2].shape == (4,) and torch.allclose(got[2].sum(), got[0].sum(), rtol=1e-5)
    with pytest.raises(ValueError):
        fused_chain_down_fd(x[:, :, :31], None, [-49.0] * 6, 1.0, 49.0, 1.0, 4, 9)
    with pytest.raises(ValueError):
        fused_chain_down_fd(x, None, [-49.0] * 6, 1.0, 49.0, 1.0, 4, 9, with_zsum=True)
