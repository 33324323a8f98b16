"""The large-plane sweep kernels' twins and routes against the JAX package (CPU).

* The twin of ``fused_rb_gibbs_sweep_2d`` (#8; FD and streamed diagonal)
  against the Pallas kernel in interpret mode, noise off, on the shapes,
  tiles and omegas of tests/test_kernels.py (1e-5 relative max-norm);
  the twin of ``fused_rb_gibbs_sweep_2d_staged`` (#9) likewise.
* Within the port: with the noise on, the #8 and #9 twins are the #7
  (FD) and #6 (streamed) twins bit for bit.
* The routes with ``rb_gibbs._PLANE_LIMIT`` patched small, so that small
  grids count as large planes: which wrapper each sweep reaches, the
  keyed Gibbs step and the keyed V(2,2) cycle with the noise off against
  the JAX ``step_with_noise``, and the keyed chains bit for bit against
  the same chains on the whole-plane route.

The CUDA kernel itself is held against these twins on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.kernels.rb_gibbs import fused_rb_gibbs_sweep_2d as jax_sweep_2d
from parmgmc_tpu.kernels.rb_gibbs import fused_rb_gibbs_sweep_2d_staged as jax_sweep_2d_staged
from parmgmc_tpu.operators.stencil import StencilOperator as JaxStencilOperator
from parmgmc_tpu.operators.stencil import shifted_laplace_fd as jax_shifted_laplace_fd
from parmgmc_tpu.samplers.gibbs import GibbsSampler as JaxGibbsSampler
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu_torch import convert, keys
from parmgmc_tpu_torch.chain import init_chain, sample_chain
from parmgmc_tpu_torch.kernels import rb_gibbs
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.samplers import gibbs
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

# the entry points default to the card; these tests run on the host
DEV = "cpu"
_WRAPPERS = ("fused_rb_gibbs_sweep_fd", "fused_rb_gibbs_sweep", "fused_rb_gibbs_sweep_2d",
             "fused_rb_gibbs_sweep_2d_staged")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(shape, kappa, seed):
    """x, b (numpy float32) and the JAX FD operator with its coefficients
    and (kappa2, hinv2)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    b = rs.randn(*shape).astype(np.float32)
    op = jax_shifted_laplace_fd(shape, kappa, dtype=jnp.float32)
    coeffs = [float(c) for c in op.coeffs]
    return x, b, op, coeffs, (float(np.float32(kappa**2)), -coeffs[0])


# -- the twins against the Pallas kernels ------------------------------------


@pytest.mark.parametrize("mode", ["fd", "streamed"])
@pytest.mark.parametrize("sweep", ["forward", "backward"])
@pytest.mark.parametrize("tile2d", [(4, 8), (2, 32)])
def test_windowed_twin_matches_jax_kernel(mode, sweep, tile2d):
    x, b, op, coeffs, fd = _inputs((8, 32, 128), 1.7, 3)
    fd_mode = mode == "fd"
    want = jax_sweep_2d(
        jnp.asarray(x), jnp.asarray(b), None if fd_mode else op.diag, jnp.asarray(coeffs, jnp.float32),
        1.3, 0, 0, noise_mult=0.0, sweep=sweep, tile2d=tile2d, interpret=True, with_noise=False,
        fd_params=jnp.asarray(fd, jnp.float32) if fd_mode else None,
    )
    diag = None if fd_mode else torch.from_numpy(np.array(op.diag))
    got = rb_gibbs.fused_rb_gibbs_sweep_2d(
        torch.from_numpy(x), torch.from_numpy(b), diag, coeffs, 1.3, 0, 0, sweep=sweep,
        with_noise=False, fd_params=fd if fd_mode else None, staged=False,
    )
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("shape", [(10, 24, 128), (12, 40, 128), (8, 48, 256)])
def test_2d_twin_matches_jax_kernel_on_odd_shapes(shape):
    x, b, _, coeffs, fd = _inputs(shape, 1.3, sum(shape))
    for sweep in ("forward", "backward"):
        want = jax_sweep_2d(
            jnp.asarray(x), jnp.asarray(b), None, jnp.asarray(coeffs, jnp.float32), 1.1, 0, 0,
            noise_mult=0.0, sweep=sweep, interpret=True, with_noise=False,
            fd_params=jnp.asarray(fd, jnp.float32),
        )
        got = rb_gibbs.fused_rb_gibbs_sweep_2d(
            torch.from_numpy(x), torch.from_numpy(b), None, coeffs, 1.1, 0, 0, sweep=sweep,
            with_noise=False, fd_params=fd,
        )
        assert _rel(got, want) < 1e-5, sweep


@pytest.mark.parametrize("sweep", ["forward", "backward"])
def test_staged_twin_matches_jax_kernel(sweep):
    x, b, _, coeffs, fd = _inputs((16, 32, 128), 1.7, 41)
    got = rb_gibbs.fused_rb_gibbs_sweep_2d_staged(
        torch.from_numpy(x), torch.from_numpy(b), coeffs, 1.2, 0, 0, sweep=sweep, with_noise=False,
        fd_params=fd,
    )
    for tile2d in ((4, 8), (8, 16)):
        want = jax_sweep_2d_staged(
            jnp.asarray(x), jnp.asarray(b), jnp.asarray(coeffs, jnp.float32), 1.2, 0, 0,
            noise_mult=0.0, sweep=sweep, tile2d=tile2d, interpret=True, with_noise=False,
            fd_params=jnp.asarray(fd, jnp.float32),
        )
        assert _rel(got, want) < 1e-5, tile2d


# -- within the port ----------------------------------------------------------


@pytest.mark.parametrize("sweep", ["forward", "backward"])
@pytest.mark.parametrize("with_b", [False, True])
def test_large_plane_twins_are_the_whole_plane_twins_bitwise(sweep, with_b):
    """With the noise on: #9 and #8 (FD) are #7, #8 (streamed) is #6."""
    shape = (6, 10, 36)
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    b = torch.from_numpy(rs.randn(*shape).astype(np.float32)) if with_b else None
    op = shifted_laplace_fd(shape, 1.5, device=DEV)
    diag = op.diag * torch.from_numpy((1.5 + 0.5 * rs.rand(*shape)).astype(np.float32))
    h = float((shape[0] - 1) ** 2)
    coeffs, fd = [-h] * 6, (2.25, h)
    kw = dict(sweep=sweep, with_noise=True)
    want = rb_gibbs.fused_rb_gibbs_sweep_fd_reference(x, b, coeffs, *fd, 1.3, 11, 4, 0.7, **kw)
    staged = rb_gibbs.fused_rb_gibbs_sweep_2d_staged(x, b, coeffs, 1.3, 11, 4, 0.7, fd_params=fd, **kw)
    windowed = rb_gibbs.fused_rb_gibbs_sweep_2d(x, b, None, coeffs, 1.3, 11, 4, 0.7, fd_params=fd,
                                                staged=False, **kw)
    assert torch.equal(staged, want) and torch.equal(windowed, want)
    want = rb_gibbs.fused_rb_gibbs_sweep_reference(x, b, diag, coeffs, 1.3, 11, 4, 0.7, **kw)
    assert torch.equal(rb_gibbs.fused_rb_gibbs_sweep_2d(x, b, diag, coeffs, 1.3, 11, 4, 0.7, **kw), want)


def test_2d_wrappers_refuse_bad_arguments():
    x = torch.zeros(4, 8, 8)
    args = ([-9.0] * 6, 1.0, 1, 2)
    with pytest.raises(ValueError):
        rb_gibbs.fused_rb_gibbs_sweep_2d_staged(x, None, *args)  # FD only
    with pytest.raises(ValueError):
        rb_gibbs.fused_rb_gibbs_sweep_2d_staged_reference(x, None, *args)
    with pytest.raises(ValueError):  # neither diag nor fd_params
        rb_gibbs.fused_rb_gibbs_sweep_2d(x, None, None, *args)
    with pytest.raises(ValueError):  # both
        rb_gibbs.fused_rb_gibbs_sweep_2d(x, None, torch.ones_like(x), *args, fd_params=(1.0, 9.0))
    with pytest.raises(ValueError):
        rb_gibbs.fused_rb_gibbs_sweep_2d(x, torch.zeros(4, 8, 9), None, *args, fd_params=(1.0, 9.0))


# -- routes -------------------------------------------------------------------


@pytest.fixture
def routes(monkeypatch):
    """Spy on every sweep wrapper; returns the list of (name, grid) calls."""
    calls = []
    for name in _WRAPPERS:
        fn = getattr(rb_gibbs, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, tuple(a[0].shape)))
            return _fn(*a, **kw)

        monkeypatch.setattr(rb_gibbs, name, spy)
    return calls


def test_sweep_wrappers_dispatch_past_the_plane_limit(routes, monkeypatch):
    x = torch.zeros(4, 8, 12)
    diag = torch.full_like(x, 40.0)
    fd_args = ([-9.0] * 6, 1.0, 9.0, 1.0, 1, 2)
    rb_gibbs.fused_rb_gibbs_sweep_fd(x, None, *fd_args)
    rb_gibbs.fused_rb_gibbs_sweep(x, None, diag, [-9.0] * 6, 1.0, 1, 2)
    assert routes == [("fused_rb_gibbs_sweep_fd", (4, 8, 12)), ("fused_rb_gibbs_sweep", (4, 8, 12))]
    routes.clear()
    monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 95)  # 96 points a plane pass it
    rb_gibbs.fused_rb_gibbs_sweep_fd(x, None, *fd_args)
    rb_gibbs.fused_rb_gibbs_sweep(x, None, diag, [-9.0] * 6, 1.0, 1, 2)
    rb_gibbs.fused_rb_gibbs_sweep_2d(x, None, None, [-9.0] * 6, 1.0, 1, 2, fd_params=(1.0, 9.0),
                                     staged=False)
    names = [c[0] for c in routes]
    assert names == ["fused_rb_gibbs_sweep_fd", "fused_rb_gibbs_sweep_2d", "fused_rb_gibbs_sweep_2d_staged",
                     "fused_rb_gibbs_sweep", "fused_rb_gibbs_sweep_2d",
                     "fused_rb_gibbs_sweep_2d"]
    routes.clear()
    monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 96)  # the limit itself stays on #7
    rb_gibbs.fused_rb_gibbs_sweep_fd(x, None, *fd_args)
    assert routes == [("fused_rb_gibbs_sweep_fd", (4, 8, 12))]


@pytest.fixture
def noise_off(monkeypatch):
    """Run the keyed paths with every draw switched off (the sweep wrappers
    the smoothers call keep their routing)."""
    for name in ("fused_rb_gibbs_sweep_fd", "fused_rb_gibbs_sweep"):
        monkeypatch.setattr(gibbs, name, functools.partial(getattr(rb_gibbs, name), with_noise=False))

    def zero_coarse_step(self, key, x, b, aux=None):
        key, _ = keys.split(key)
        eta = torch.zeros(self.n, dtype=self.dtype, device=self.L.device)
        return key, self.step_with_noise(x, b, [{"eta": eta}], aux)

    def zero_coarse_step_from(self, cur, x, b, aux=None):
        cur.generator(self.L.device)
        eta = torch.zeros(self.n, dtype=self.dtype, device=self.L.device)
        return self.step_with_noise(x, b, [{"eta": eta}], aux)

    monkeypatch.setattr(CholeskySampler, "step", zero_coarse_step)
    monkeypatch.setattr(CholeskySampler, "step_from", zero_coarse_step_from)


def _zeros(shapes):
    if isinstance(shapes, tuple):
        return np.zeros(shapes, np.float32)
    if isinstance(shapes, dict):
        return {k: _zeros(v) for k, v in shapes.items()}
    return [_zeros(v) for v in shapes]


def _field_operator(shape, kappa):
    """The FD operator with its diagonal times a smooth field in [1, 2]:
    a star stencil that is not link-count FD (the streamed-diagonal sweep)."""
    fd = shifted_laplace_fd(shape, kappa, device=DEV)
    i, j, k = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    field = 1.5 + 0.5 * np.sin(0.9 * i + 0.4 * j) * np.cos(0.3 * k)
    diag = fd.diag.numpy() * field.astype(np.float32)
    return convert.stencil_operator(fd.offsets, [c.numpy() for c in fd.coeffs], diag, DEV)


@pytest.mark.parametrize("sweep", ["forward", "symmetric"])
@pytest.mark.parametrize("mode", ["fd", "streamed"])
def test_keyed_gibbs_on_large_planes_without_noise_is_the_jax_step(routes, noise_off, monkeypatch, mode,
                                                                   sweep):
    monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 32)
    shape = (6, 8, 10)
    op = shifted_laplace_fd(shape, 2.0, device=DEV) if mode == "fd" else _field_operator(shape, 2.0)
    smp = gibbs.GibbsSampler.create(op, omega=1.3, sweep=sweep)
    jop = JaxStencilOperator(
        offsets=op.offsets, coeffs=tuple(jnp.asarray(c.numpy()) for c in op.coeffs),
        diag=jnp.asarray(op.diag.numpy()),
    )
    jsmp = JaxGibbsSampler.create(jop, omega=1.3, sweep=sweep, impl="lax")
    rs = np.random.RandomState(9)
    x, b = rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)
    _, got = smp.step(3, torch.from_numpy(x), torch.from_numpy(b))
    zeros = jax.tree_util.tree_map(jnp.asarray, _zeros(smp.noise_shapes()))
    want = jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(b), zeros)
    assert _rel(got, want) < 1e-5
    kernel = "fused_rb_gibbs_sweep_2d_staged" if mode == "fd" else "fused_rb_gibbs_sweep_2d"
    assert [c[0] for c in routes].count(kernel) == (2 if sweep == "symmetric" else 1)


@pytest.mark.parametrize("with_b", [False, True])
def test_keyed_v22_on_large_planes_without_noise_is_the_jax_cycle(routes, noise_off, monkeypatch, with_b):
    monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 32)  # level 0 (128 points a plane) passes it
    jsmp = JaxMGMCSampler.create(
        jax_shifted_laplace_fd((8, 8, 16), 1.3, dtype=jnp.float32), coarsest_size=16,
        coarsening="aggregate", impl="lax", n_pre=2, n_post=2,
    )
    ops = [
        convert.stencil_operator(o.offsets, [np.asarray(c) for c in o.coeffs], np.asarray(o.diag), DEV)
        for o in jsmp.ops
    ]
    smp = convert.mgmc_sampler(ops, np.asarray(jsmp.coarse.L), np.asarray(jsmp.coarse.Li), device=DEV,
                               n_pre=2, n_post=2)
    assert smp.n_levels == 3 and not smp.deferred_eligible()
    rs = np.random.RandomState(8)
    x = rs.randn(8, 8, 16).astype(np.float32)
    b = rs.randn(8, 8, 16).astype(np.float32) if with_b else None
    _, got = smp.step(17, torch.from_numpy(x), None if b is None else torch.from_numpy(b))
    zeros = jax.tree_util.tree_map(jnp.asarray, _zeros(smp.noise_shapes()))
    want = jsmp.step_with_noise(jnp.asarray(x), None if b is None else jnp.asarray(b), zeros)
    assert _rel(got, want) < 1e-5
    # 4 sweeps on each smoothed level: level 0 on #9, level 1 (32 points a plane) on #7
    staged = [c for c in routes if c[0] == "fused_rb_gibbs_sweep_2d_staged"]
    whole = [c for c in routes if c[0] == "fused_rb_gibbs_sweep_fd" and c[1] == (4, 4, 8)]
    assert staged == [("fused_rb_gibbs_sweep_2d_staged", (8, 8, 16))] * 4 and len(whole) == 4


@pytest.mark.parametrize("case", ["v22", "gibbs_fd", "gibbs_streamed"])
def test_keyed_chains_are_bitwise_across_routes(routes, monkeypatch, case):
    """With the noise on, the chains on the large-plane route are the
    chains on the whole-plane route, bit for bit."""
    shape = (8, 8, 16)
    if case == "v22":
        smp = MGMCSampler.create(shifted_laplace_fd(shape, 1.0, device=DEV), n_pre=2, n_post=2,
                                 coarsest_size=16, coarsening="aggregate")
    elif case == "gibbs_fd":
        smp = gibbs.GibbsSampler.create(shifted_laplace_fd(shape, 2.0, device=DEV), sweep="symmetric")
    else:
        smp = gibbs.GibbsSampler.create(_field_operator(shape, 2.0), sweep="forward")
    b = torch.full(shape, 3.0)
    st = init_chain(smp, 4)
    whole, qw = sample_chain(smp, st, b, 3, extract=torch.mean)
    assert not any(c[0].startswith("fused_rb_gibbs_sweep_2d") for c in routes)
    monkeypatch.setattr(rb_gibbs, "_PLANE_LIMIT", 16)
    large, ql = sample_chain(smp, st, b, 3, extract=torch.mean)
    assert any(c[0].startswith("fused_rb_gibbs_sweep_2d") for c in routes)
    assert torch.equal(whole.x, large.x) and torch.equal(qw, ql) and whole.key == large.key
