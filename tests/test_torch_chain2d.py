"""The large-plane chain kernels' twins and routes against the JAX package (CPU).

* The twins of ``fused_chain_down_2d`` (#4), ``fused_chain_down_2d_staged``
  (#5) and ``fused_zero_gibbs_restrict_fd`` (#3) against the Pallas
  kernels in interpret mode, noise off (the tolerances of
  tests/test_kernels.py: xpy/y 1e-5, rc 1e-4, relative max-norm; partial
  sums compared as totals).  The JAX carries ``zf`` and ``zx2`` reach the
  port through ``convert.deferred_carry_from_jax``.
* Within the port: #3's twin is #5's twin with x = 0, bit for bit.
* The keyed V(1,0) routes with ``_PLANE_LIMIT`` patched small, so that
  small grids count as large planes: which wrapper each level reaches,
  the cycle with the noise off against the JAX ``step_with_noise``, and
  the deferred chain bit for bit against ``sample_chain``.

The CUDA kernel itself is held against these twins on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.kernels.mg_sweep import fused_chain_down_2d as jax_chain_2d
from parmgmc_tpu.kernels.mg_sweep import fused_chain_down_2d_staged as jax_chain_2d_staged
from parmgmc_tpu.kernels.mg_sweep import fused_zero_gibbs_restrict_fd as jax_zero_restrict
from parmgmc_tpu.operators.stencil import shifted_laplace_fd as jax_shifted_laplace_fd
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu_torch import convert
from parmgmc_tpu_torch.chain import init_chain, sample_chain, sample_chain_deferred
from parmgmc_tpu_torch.kernels import mg_sweep, mg_tail, rb_gibbs
from parmgmc_tpu_torch.operators.stencil import fd_stencil
from parmgmc_tpu_torch.samplers import mgmc
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler

# the entry points default to the card; these tests run on the host
DEV = "cpu"
SHAPE = (16, 32, 128)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    b = rs.randn(*shape).astype(np.float32)
    z = rs.randn(*(s // 2 for s in shape)).astype(np.float32)
    hinv2 = float((shape[0] - 1) ** 2)
    return x, b, z, hinv2


def _rc(rq, shape):
    return np.asarray(rq).reshape(shape[0] // 2, shape[1] // 2, shape[2] // 2, 2).sum(-1)


def _check_sums(got, jax_xsum, jax_zsum, xpy, z, zweight):
    """Totals of the partial sums: JAX sums the carry in its own layout,
    ``zweight`` times the compact sum."""
    scale = float(np.abs(np.asarray(xpy, np.float64)).sum())
    assert abs(float(got[2].double().sum()) - float(np.asarray(jax_xsum, np.float64).sum())) < 1e-5 * scale
    zscale = zweight * float(np.abs(z.astype(np.float64)).sum())
    zt = zweight * float(got[3].double().sum())
    assert abs(zt - float(np.asarray(jax_zsum, np.float64).sum())) < 1e-5 * zscale


@pytest.mark.parametrize("sweep", ["forward", "backward"])
@pytest.mark.parametrize("case", ["b", "b=None,zf"])
def test_windowed_twin_matches_jax_kernel(sweep, case):
    x, b, z, hinv2 = _inputs(SHAPE, 3)
    coeffs = [-hinv2] * 6
    args = (1.7**2, hinv2, 1.0, 3, 5)
    zf = np.repeat(np.repeat(z, 2, axis=1), 2, axis=2)  # (N0/2, N1, N2)
    use_z = case != "b"
    jkw = dict(zf=jnp.asarray(zf), with_xsum=True, with_zsum=True) if use_z else {}
    out_j = jax_chain_2d(
        jnp.asarray(x), None if use_z else jnp.asarray(b), jnp.asarray(coeffs, jnp.float32),
        *args, sweep=sweep, tile2d=(4, 8), staged=False, interpret=True, with_noise=False, **jkw,
    )
    zt = convert.deferred_carry_from_jax(zf, "zf", DEV) if use_z else None
    assert not use_z or np.array_equal(zt.numpy(), z)
    got = mg_sweep.fused_chain_down_2d(
        torch.from_numpy(x), None if use_z else torch.from_numpy(b), coeffs, *args,
        sweep=sweep, with_noise=False, z=zt, with_xsum=use_z, with_zsum=use_z,
    )
    assert _rel(got[0], out_j[0]) < 1e-5
    assert _rel(got[1], _rc(out_j[1], SHAPE)) < 1e-4
    if use_z:
        # JAX zsum sums zf: sum(P0 z) = 2 sum(zf) = 8 sum(z)
        _check_sums(got, out_j[2], out_j[3], out_j[0], z, 4.0)


@pytest.mark.parametrize("sweep", ["forward", "backward"])
@pytest.mark.parametrize("layout,tile", [("zf", (4, 8)), ("zx2", (4, 16))])
def test_staged_twin_matches_jax_kernel(sweep, layout, tile):
    x, b, z, hinv2 = _inputs(SHAPE, 4)
    coeffs = [-hinv2] * 6
    args = (1.0, hinv2, 1.0, 3, 5)
    if layout == "zf":
        zj = np.repeat(np.repeat(z, 2, axis=1), 2, axis=2)
        zweight = 4.0  # sum(zf) = 4 sum(z)
    else:
        zj = np.repeat(z, 2, axis=-1)
        zweight = 2.0  # sum(zx2) = 2 sum(z)
    zt = convert.deferred_carry_from_jax(zj, layout, DEV)
    assert np.array_equal(zt.numpy(), z)
    # b given with the carry on the zf case, b = None (the prior path) on zx2
    bj = jnp.asarray(b) if layout == "zf" else None
    bt = torch.from_numpy(b) if layout == "zf" else None
    out_j = jax_chain_2d_staged(
        jnp.asarray(x), bj, jnp.asarray(coeffs, jnp.float32), *args, sweep=sweep, tile2d=tile,
        interpret=True, with_noise=False, with_xsum=True, with_zsum=True,
        **{layout: jnp.asarray(zj)},
    )
    got = mg_sweep.fused_chain_down_2d_staged(
        torch.from_numpy(x), bt, coeffs, *args, sweep=sweep, with_noise=False, z=zt,
        with_xsum=True, with_zsum=True,
    )
    assert _rel(got[0], out_j[0]) < 1e-5
    assert _rel(got[1], _rc(out_j[1], SHAPE)) < 1e-4
    _check_sums(got, out_j[2], out_j[3], out_j[0], z, zweight)
    # one partial per column strip
    tile_t = mg_sweep.MARCH_TILE
    assert got[2].shape == (-(-SHAPE[1] // tile_t[1]) * -(-SHAPE[2] // tile_t[2]),)


@pytest.mark.parametrize("shape,sweep", [(SHAPE, "forward"), (SHAPE, "backward"), ((8, 10, 128), "forward")])
def test_zero_restrict_twin_matches_jax_kernel(shape, sweep):
    _, b, _, hinv2 = _inputs(shape, 5)
    coeffs = [-hinv2] * 6
    args = (2.0, hinv2, 1.1, 3, 5)
    y_j, rq_j = jax_zero_restrict(
        jnp.asarray(b), jnp.asarray(coeffs, jnp.float32), *args, sweep=sweep, interpret=True,
        with_noise=False,
    )
    y_t, rc_t = mg_sweep.fused_zero_gibbs_restrict_fd(
        torch.from_numpy(b), coeffs, *args, sweep=sweep, with_noise=False
    )
    assert _rel(y_t, y_j) < 1e-5
    assert _rel(rc_t, _rc(rq_j, shape)) < 1e-4


@pytest.mark.parametrize("with_noise", [False, True])
def test_zero_restrict_twin_is_the_staged_twin_from_zero(with_noise):
    shape = (8, 10, 36)
    _, b, _, hinv2 = _inputs(shape, 6)
    bt = torch.from_numpy(b)
    args = ([-hinv2] * 6, 1.0, hinv2, 1.2, 7, 9)
    for sweep in ("forward", "backward"):
        y, rc = mg_sweep.fused_zero_gibbs_restrict_fd(bt, *args, sweep=sweep, with_noise=with_noise)
        xpy, rc5 = mg_sweep.fused_chain_down_2d_staged(
            torch.zeros_like(bt), bt, *args, sweep=sweep, with_noise=with_noise
        )
        assert torch.equal(y, xpy) and torch.equal(rc, rc5)
        # and the windowed twin is the staged one
        xpy4, rc4 = mg_sweep.fused_chain_down_2d(
            torch.zeros_like(bt), bt, *args, sweep=sweep, with_noise=with_noise
        )
        assert torch.equal(xpy4, xpy) and torch.equal(rc4, rc5)


def test_supported_shapes_and_refusals():
    assert mg_sweep.chain_down_2d_supported((768, 768, 768))
    assert mg_sweep.chain_down_2d_supported((12, 770, 772))
    assert not mg_sweep.chain_down_2d_supported((12, 771, 772))
    assert not mg_sweep.chain_down_2d_supported((768, 768))
    assert not mg_sweep.chain_down_2d_supported((2048, 2048, 1024))  # 2^32 points
    x = torch.zeros(8, 8, 31)
    with pytest.raises(ValueError):
        mg_sweep.fused_zero_gibbs_restrict_fd(x, [-1.0] * 6, 1.0, 1.0, 1.0, 1, 2)
    with pytest.raises(ValueError):
        mg_sweep.fused_chain_down_2d_staged(torch.zeros(8, 8, 32), None, [-1.0] * 6, 1.0, 1.0, 1.0,
                                            1, 2, with_zsum=True)
    with pytest.raises(ValueError):
        convert.deferred_carry_from_jax(np.zeros((4, 4, 8)), "zq", DEV)


# -- routes -------------------------------------------------------------------


def _spy(monkeypatch, module, names, calls, **fixed):
    """Record each call of module.<name> (with the grid it got), running
    the wrapper with ``fixed`` keyword arguments."""
    for name in names:
        fn = getattr(module, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, tuple(a[0].shape)))
            return _fn(*a, **{**kw, **fixed})

        monkeypatch.setattr(module, name, spy)


_CHAIN = ("fused_chain_down_fd", "fused_chain_down_2d", "fused_chain_down_2d_staged",
          "fused_zero_gibbs_restrict_fd")


@pytest.fixture
def large_planes(monkeypatch):
    """Small grids count as large planes.  Returns record(**fixed): spy
    on every kernel wrapper (with ``fixed`` keyword arguments) and return
    the list its calls go to."""
    monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 64)

    def record(**fixed):
        calls = []
        _spy(monkeypatch, mg_sweep, _CHAIN, calls, **fixed)
        _spy(monkeypatch, mg_tail, ("fused_tail_down",), calls, **fixed)
        return calls

    return record


def _zeros(shapes):
    if isinstance(shapes, tuple):
        return jnp.zeros(shapes, jnp.float32)
    if isinstance(shapes, dict):
        return {k: _zeros(v) for k, v in shapes.items()}
    return [_zeros(v) for v in shapes]


def _sampler(shape):
    op = fd_stencil(shape, 1.69, float((shape[0] - 1) ** 2), device=DEV)
    return mgmc.MGMCSampler.create(op, n_pre=1, n_post=0, coarsest_size=16,
                                   coarsening="aggregate")


def test_routes_reach_the_kernels_the_jax_package_runs(large_planes):
    calls = large_planes()
    # (8, 16, 48) -> (4, 8, 24) -> (2, 4, 12): level 1's n2 does not divide 128
    smp = _sampler((8, 16, 48))
    assert smp.n_levels == 3 and smp._chain_level0_2d() and smp.deferred_eligible()
    assert not smp._tail_fused_eligible(1)
    x = torch.zeros(8, 16, 48)
    smp.step(1, x, None)
    assert calls == [("fused_chain_down_2d", (8, 16, 48)), ("fused_zero_gibbs_restrict_fd", (4, 8, 24))]
    calls.clear()
    smp.step_deferred(1, x, smp.deferred_init(x.dtype), None)
    assert calls == [("fused_chain_down_2d_staged", (8, 16, 48)), ("fused_zero_gibbs_restrict_fd", (4, 8, 24))]
    calls.clear()
    smp.fmg_init(2, None)  # level 1 then level 0, each from zero
    assert calls == [("fused_zero_gibbs_restrict_fd", (4, 8, 24)), ("fused_zero_gibbs_restrict_fd", (8, 16, 48)),
                     ("fused_zero_gibbs_restrict_fd", (4, 8, 24))]
    calls.clear()
    # (8, 16, 64) -> (4, 8, 32) -> (2, 4, 16): the JAX rule gives level 1 the tail
    smp = _sampler((8, 16, 64))
    assert smp._tail_fused_eligible(1)
    smp.step(1, torch.zeros(8, 16, 64), None)
    assert calls == [("fused_chain_down_2d", (8, 16, 64)), ("fused_tail_down", (4, 8, 32))]


def test_small_planes_keep_the_whole_plane_kernel(monkeypatch):
    calls = []
    _spy(monkeypatch, mg_sweep, _CHAIN, calls)
    smp = _sampler((8, 16, 48))
    assert not smp._chain_level0_2d()  # 768 points a plane
    smp.step_deferred(1, torch.zeros(8, 16, 48), smp.deferred_init(torch.float32), None)
    assert calls == [("fused_chain_down_fd", (8, 16, 48)), ("fused_zero_gibbs_restrict_fd", (4, 8, 24))]


@pytest.mark.parametrize("shape", [(8, 16, 48), (8, 16, 64)])
@pytest.mark.parametrize("with_b", [False, True])
def test_keyed_cycle_without_noise_is_the_jax_explicit_cycle(large_planes, monkeypatch, shape, with_b):
    calls = large_planes(with_noise=False)

    def zero_coarse_step(self, cur, x, b, aux=None):
        cur.generator(self.L.device)  # the draw's word, unused
        eta = torch.zeros(self.n, dtype=self.dtype, device=self.L.device)
        return self.step_with_noise(x, b, [{"eta": eta}], aux)

    monkeypatch.setattr(CholeskySampler, "step_from", zero_coarse_step)
    jsmp = JaxMGMCSampler.create(
        jax_shifted_laplace_fd(shape, 1.3, dtype=jnp.float32), n_pre=1, n_post=0, coarsest_size=16,
        coarsening="aggregate", impl="lax",
    )
    ops = [
        convert.stencil_operator(o.offsets, [np.asarray(c) for c in o.coeffs], np.asarray(o.diag), DEV)
        for o in jsmp.ops
    ]
    smp = convert.mgmc_sampler(ops, np.asarray(jsmp.coarse.L), np.asarray(jsmp.coarse.Li), device=DEV,
                               n_pre=1, n_post=0)
    assert smp.n_levels == jsmp.n_levels == 3 and smp.deferred_eligible() and smp._chain_level0_2d()
    rs = np.random.RandomState(10)
    x = rs.randn(*shape).astype(np.float32)
    b = rs.randn(*shape).astype(np.float32) if with_b else None
    zeros = _zeros(jsmp.noise_shapes())
    _, got = smp.step(17, torch.from_numpy(x), None if b is None else torch.from_numpy(b))
    want = jsmp.step_with_noise(jnp.asarray(x), None if b is None else jnp.asarray(b), zeros)
    level1 = "fused_tail_down" if shape[2] == 64 else "fused_zero_gibbs_restrict_fd"
    assert [c[0] for c in calls] == ["fused_chain_down_2d", level1]
    assert _rel(got, want) < 1e-5


def test_deferred_chain_is_bitwise_the_plain_chain_on_large_planes(large_planes):
    calls = large_planes()
    smp = _sampler((8, 16, 48))
    b = torch.from_numpy(np.random.RandomState(7).randn(8, 16, 48).astype(np.float32))
    for rhs in (None, b):
        st = init_chain(smp, 11)
        sa, qa = sample_chain(smp, st, rhs, 6, extract=torch.mean)
        sb, qb = sample_chain_deferred(smp, st, rhs, 6)
        assert torch.equal(sa.x, sb.x) and sa.key == sb.key
        assert (qa - qb).abs().max() <= 1e-5 * qa.abs().max()
    names = {c[0] for c in calls}
    assert names == {"fused_chain_down_2d", "fused_chain_down_2d_staged", "fused_zero_gibbs_restrict_fd"}
