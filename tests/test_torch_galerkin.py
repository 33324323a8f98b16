"""The port's linear hierarchy against the JAX package (CPU).

* ``prolong`` / ``restrict`` against JAX (float64, 1e-14), restrict the
  exact transpose of prolong (1e-12), interior partition of unity, and
  ``GeometricTransfer.prolong_add``;
* the 27-point levels' sweep, colour by colour on sublattices, bit for
  bit the masked sweep;
* ``galerkin_coarse_operator`` under the linear and the aggregate
  transfer against JAX (the same offsets, fields to 1e-12) and against
  the dense P^T A P (1e-11), coarsened twice, and ``compress_stencil``
  of each keeping JAX's offsets and scalar-or-field split;
* ``build_hierarchy``, linear and aggregate on odd extents, against JAX
  (level shapes, transfer types, dense operators to 1e-12), and the LRC
  hierarchy's per-level B_c;
* the linear MGMC explicit-noise cycle against JAX in float64 (V(2,2),
  W, symmetric; 2D and 3D, 1e-12), the exact invariance identity
  (< 1e-10), and the keyed step with every draw off against JAX's
  ``step_with_noise`` with zero noises (float32, 1e-4);
* fault F3: a linear hierarchy never reaches the chain kernels (#1, #2,
  #3), on the prior and on the posterior, and ``fmg_init`` takes the
  general cycle there.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.models.obs import make_posterior_operator as jax_make_posterior_operator
from parmgmc_tpu.models.problems import gmrf_2d as jax_gmrf_2d
from parmgmc_tpu.models.problems import gmrf_3d as jax_gmrf_3d
from parmgmc_tpu.operators import stencil as jst
from parmgmc_tpu.operators.transfer import AggregateTransfer as JaxAggregateTransfer
from parmgmc_tpu.operators.transfer import GeometricTransfer as JaxGeometricTransfer
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu.samplers.mgmc import build_hierarchy as jax_build_hierarchy
from parmgmc_tpu_torch import convert, keys
from parmgmc_tpu_torch.kernels import galerkin_sweep, mg_sweep, mg_tail, rb_gibbs
from parmgmc_tpu_torch.models.obs import make_posterior_operator
from parmgmc_tpu_torch.models.problems import gmrf_2d, gmrf_3d
from parmgmc_tpu_torch.operators import stencil as st
from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.operators.transfer import AggregateTransfer, GeometricTransfer
from parmgmc_tpu_torch.samplers import gibbs
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler, build_hierarchy
from parmgmc_tpu_torch.testing import invariance_error

# the entry points default to the card; these tests run on the host
DEV = "cpu"
F32, F64 = torch.float32, torch.float64
TRANSFERS = {"linear": (GeometricTransfer, JaxGeometricTransfer),
             "aggregate": (AggregateTransfer, JaxAggregateTransfer)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _dense_p(transfer, cshape):
    """Dense P (n_fine, n_coarse) by prolonging every coarse unit vector."""
    nc = int(np.prod(cshape))
    cols = transfer.prolong(torch.eye(nc, dtype=F64).T.reshape(*cshape, nc))
    return cols.reshape(-1, nc)


@pytest.mark.parametrize("fshape", [(9, 9), (8, 8), (7, 10), (5, 6, 7)])
def test_transfers_match_jax(fshape):
    rs = np.random.RandomState(0)
    cshape = st.coarse_shape(fshape)
    c, f = rs.randn(*cshape), rs.randn(*fshape)
    tr = GeometricTransfer(fine_shape=fshape)
    pc, rf = tr.prolong(torch.from_numpy(c)), tr.restrict(torch.from_numpy(f))
    assert np.abs(pc.numpy() - np.asarray(jst.prolong(jnp.asarray(c), fshape))).max() <= 1e-14
    assert np.abs(rf.numpy() - np.asarray(jst.restrict(jnp.asarray(f)))).max() <= 1e-14
    # restrict is the exact transpose of prolong
    assert abs(float((pc * torch.from_numpy(f)).sum() - (torch.from_numpy(c) * rf).sum())) < 1e-12
    # interior partition of unity (constants interpolate exactly everywhere)
    ones = tr.prolong(torch.ones(cshape, dtype=F64))
    assert ones.shape == fshape and float((ones - 1.0).abs().max()) <= 1e-14
    y = torch.from_numpy(rs.randn(*fshape))
    assert torch.equal(tr.prolong_add(y, torch.from_numpy(c)), y + pc)
    assert convert.geometric_transfer(fshape) == tr


def _fd(shape, kappa=3.0):
    return (st.shifted_laplace_fd(shape, kappa, F64, device=DEV),
            jst.shifted_laplace_fd(shape, kappa, dtype=jnp.float64))


@pytest.mark.parametrize("coarsening", ["linear", "aggregate"])
@pytest.mark.parametrize("fshape", [(9, 9), (8, 8), (9, 8), (7, 7, 7), (8, 8, 8)])
def test_galerkin_coarse_operator_matches_jax(fshape, coarsening):
    op, jop = _fd(fshape)
    cls, jcls = TRANSFERS[coarsening]
    tr = cls(fine_shape=fshape)
    opc = st.galerkin_coarse_operator(op, tr)
    jopc = jst.galerkin_coarse_operator(jop, jcls(fine_shape=fshape))
    assert opc.offsets == jopc.offsets
    for got, want in zip((*opc.coeffs, opc.diag), (*jopc.coeffs, jopc.diag)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-12 * np.abs(np.asarray(jopc.diag)).max()
    P = _dense_p(tr, st.coarse_shape(fshape))
    assert float((opc.to_dense() - P.T @ op.to_dense() @ P).abs().max()) <= 1e-11
    # compressed: JAX's offsets and the same scalar-or-field split
    cc, jcc = st.compress_stencil(opc), jst.compress_stencil(jopc)
    assert cc.offsets == jcc.offsets
    assert [c.ndim for c in cc.coeffs] == [np.ndim(c) for c in jcc.coeffs]
    assert float((cc.to_dense() - opc.to_dense()).abs().max()) == 0.0
    if coarsening == "linear":  # the default transfer is the linear one
        assert torch.equal(st.galerkin_coarse_operator(op).diag, opc.diag)


def test_galerkin_twice_levels():
    """Coarsening a 9-point coarse operator again stays exact."""
    op, _ = _fd((9, 9), 1.0)
    op1 = st.galerkin_coarse_operator(op)
    op2 = st.galerkin_coarse_operator(op1)
    c1 = st.coarse_shape((9, 9))
    P = _dense_p(GeometricTransfer(fine_shape=c1), st.coarse_shape(c1))
    assert float((op2.to_dense() - P.T @ op1.to_dense() @ P).abs().max()) <= 1e-11
    assert len(op1.offsets) == len(op2.offsets) == 8 and not op1.is_star()


@pytest.mark.parametrize("case", ["9-point", "27-point odd", "radius 2"])
def test_sublattice_sweep_is_the_masked_sweep(case):
    """A dense colouring's sweep updates each colour's sublattice alone:
    bit for bit the masked whole-grid sweep (the colour masks given)."""
    from parmgmc_tpu_torch.models.problems import squared_shifted_laplace_fd
    from parmgmc_tpu_torch.samplers.sor import color_masks, num_colors, sor_sweep

    if case == "radius 2":
        op = squared_shifted_laplace_fd((7, 6), 1.1, F64, device=DEV)
    else:
        fshape = (9, 9) if case == "9-point" else (7, 10, 9)
        op = st.compress_stencil(st.galerkin_coarse_operator(st.shifted_laplace_fd(fshape, 1.3, F32, device=DEV)))
    assert not op.is_star()
    masks = color_masks(op.grid_shape, num_colors(op), op, device=DEV)
    gen = torch.Generator().manual_seed(0)
    x, b = (torch.randn(op.grid_shape, generator=gen, dtype=op.dtype) for _ in range(2))
    for sweep in ("forward", "backward", "symmetric"):
        for omega in (1.0, 1.3):
            assert torch.equal(sor_sweep(op, b, x, omega, sweep), sor_sweep(op, b, x, omega, sweep, masks))


HIERARCHIES = {
    "gmrf_2d(64) linear": (lambda: gmrf_2d(64, 1.0, F64, device=DEV),
                           lambda: jax_gmrf_2d(64, 1.0, jnp.float64), dict(coarsening="linear")),
    "gmrf_3d(9) linear": (lambda: gmrf_3d(9, 1.0, F64, device=DEV),
                          lambda: jax_gmrf_3d(9, 1.0, jnp.float64), dict(coarsening="linear", coarsest_size=16)),
    "gmrf_3d(16) linear": (lambda: gmrf_3d(16, 1.0, F64, device=DEV),
                           lambda: jax_gmrf_3d(16, 1.0, jnp.float64), dict(coarsening="linear", coarsest_size=16)),
    "gmrf_3d(9) aggregate": (lambda: gmrf_3d(9, 1.0, F64, device=DEV), lambda: jax_gmrf_3d(9, 1.0, jnp.float64),
                             dict(coarsening="aggregate", coarsest_size=16)),
}


@pytest.mark.parametrize("case", list(HIERARCHIES))
def test_hierarchy_matches_jax(case):
    make, jmake, kw = HIERARCHIES[case]
    ops, trs = build_hierarchy(make(), **kw)
    jops, jtrs = jax_build_hierarchy(jmake(), **kw)
    assert len(ops) == len(jops) >= 3
    assert [o.grid_shape for o in ops] == [tuple(o.grid_shape) for o in jops]
    cls, jcls = TRANSFERS[kw["coarsening"]]
    assert all(isinstance(t, cls) for t in trs) and all(isinstance(t, jcls) for t in jtrs)
    assert [t.fine_shape for t in trs] == [tuple(t.fine_shape) for t in jtrs]
    for o, jo in zip(ops[1:], jops[1:]):
        assert o.offsets == jo.offsets
        assert [c.ndim for c in o.coeffs] == [np.ndim(c) for c in jo.coeffs]
        assert _rel(o.to_dense(), jo.to_dense()) <= 1e-12


def test_lrc_linear_hierarchy_matches_jax():
    args = (0.05, np.array([[0.3, 0.4], [0.6, 0.7]]), np.full(2, 0.2), np.ones(2))
    op, _ = make_posterior_operator(st.shifted_laplace_fd((12, 10), 1.0, F64, device=DEV), *args)
    jop, _ = jax_make_posterior_operator(jst.shifted_laplace_fd((12, 10), 1.0, dtype=jnp.float64), *args)
    ops, _ = build_hierarchy(op, coarsest_size=8)
    jops, _ = jax_build_hierarchy(jop, coarsest_size=8)
    assert [o.grid_shape for o in ops] == [tuple(o.grid_shape) for o in jops] == [(12, 10), (6, 5), (3, 3)]
    for o, jo in zip(ops, jops):
        assert isinstance(o, LRCOperator) and _rel(o.B, jo.B) <= 1e-12
        assert o.cols.windowed == (jo.patch_vals is not None)
        assert _rel(o.base.to_dense(), jo.base.to_dense()) <= 1e-12


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


def _port_sampler(jsmp, kw, coarsening="linear"):
    """The port's sampler over JAX's levels (carried across) and coarse
    factors."""
    ops = [convert.stencil_operator_from(o, DEV) for o in jsmp.ops]
    return convert.mgmc_sampler(ops, np.asarray(jsmp.coarse.L), np.asarray(jsmp.coarse.Li),
                                coarsening=coarsening, device=DEV, **kw)


CYCLES = {"V22": dict(n_pre=2, n_post=2), "W11": dict(n_pre=1, n_post=1, gamma=2),
          "sym": dict(n_pre=1, n_post=1, sweep="symmetric", omega=1.2)}


@pytest.mark.parametrize("cycle", list(CYCLES))
@pytest.mark.parametrize("dim", [2, 3])
def test_linear_step_with_noise_matches_jax(cycle, dim):
    kw = CYCLES[cycle]
    jop = jax_gmrf_2d(9, 1.0, jnp.float64) if dim == 2 else jax_gmrf_3d(7, 1.0, jnp.float64)
    jsmp = JaxMGMCSampler.create(jop, coarsest_size=8, impl="lax", **kw)
    smp = _port_sampler(jsmp, kw)
    assert smp.n_levels == jsmp.n_levels == 3
    assert smp.noise_shapes() == jsmp.noise_shapes()
    rs = np.random.RandomState(5)
    x, b = rs.randn(*jop.grid_shape), rs.randn(*jop.grid_shape)
    noises = _numpy_noises(smp.noise_shapes(), rs)
    for bb in (None, b):
        got = smp.step_with_noise(torch.from_numpy(x), None if bb is None else torch.from_numpy(bb),
                                  convert.tree(noises, DEV))
        want = jsmp.step_with_noise(jnp.asarray(x), None if bb is None else jnp.asarray(bb),
                                    jax.tree_util.tree_map(jnp.asarray, noises))
        assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("cycle", ["V22", "sym"])
def test_linear_invariance(cycle):
    op = gmrf_2d(9, 1.0, F64, device=DEV)
    smp = MGMCSampler.create(op, coarsest_size=8, **CYCLES[cycle])
    assert smp.n_levels == 3 and isinstance(smp.transfers[0], GeometricTransfer)
    b = torch.from_numpy(np.random.RandomState(6).randn(9, 9))
    mean_err, cov_err = invariance_error(smp, op, b)
    assert mean_err < 1e-10 and cov_err < 1e-10, (mean_err, cov_err)


@pytest.fixture
def noise_off(monkeypatch):
    """Run the keyed paths with every draw switched off: the sweep
    kernels' noise (the star and the 27-point ones), the plain levels' and
    the coarse sample's draws (keyed, or on a cursor's words), and the
    low-rank draws of an LRC smoother."""
    for name in ("fused_rb_gibbs_sweep_fd", "fused_rb_gibbs_sweep"):
        monkeypatch.setattr(gibbs, name, functools.partial(getattr(rb_gibbs, name), with_noise=False))
    monkeypatch.setattr(gibbs, "fused_galerkin_sweep",
                        functools.partial(galerkin_sweep.fused_galerkin_sweep, with_noise=False))

    def zeros(key, shapes, dtype, device):
        if isinstance(shapes, tuple):
            return torch.zeros(shapes, dtype=dtype, device=device)
        if isinstance(shapes, dict):
            return {k: zeros(key, v, dtype, device) for k, v in shapes.items()}
        return [zeros(key, v, dtype, device) for v in shapes]

    def zero_coarse_step(self, key, x, b, aux=None):
        key, _ = keys.split(key)
        return key, self.step_with_noise(x, b, [{"eta": torch.zeros(self.n, dtype=self.dtype)}], aux)

    monkeypatch.setattr(gibbs, "_draw", zeros)
    monkeypatch.setattr(gibbs, "_lowrank_draw", lambda key, scale, n: torch.zeros(n, scale.shape[0],
                                                                                 dtype=scale.dtype))
    def zero_coarse_step_from(self, cur, x, b, aux=None):
        cur.generator(self.device)
        return self.step_with_noise(x, b, [{"eta": torch.zeros(self.n, dtype=self.dtype)}], aux)

    monkeypatch.setattr(CholeskySampler, "step", zero_coarse_step)
    monkeypatch.setattr(CholeskySampler, "step_from", zero_coarse_step_from)


@pytest.fixture
def no_chain_kernels(monkeypatch):
    """#1, #2 and #3 (and their large-plane modes) raise if called."""
    def refuse(*a, **k):
        raise AssertionError("a chain kernel ran on a linear hierarchy")

    for name in ("fused_chain_down_fd", "fused_chain_down_2d", "fused_chain_down_2d_staged",
                 "fused_zero_gibbs_restrict_fd"):
        monkeypatch.setattr(mg_sweep, name, refuse)
    monkeypatch.setattr(mg_tail, "fused_tail_down", refuse)


@pytest.mark.parametrize("with_b", [False, True])
def test_keyed_linear_step_without_noise_matches_jax(noise_off, no_chain_kernels, with_b):
    """V(2,2) on (8, 8, 16): level 0 on the FD sweep's twin, the 27-point
    level 1 on the 27-point sweep's twin, all draws off, against JAX's
    explicit cycle with zero noises (float32)."""
    kw = CYCLES["V22"]
    jsmp = JaxMGMCSampler.create(jst.shifted_laplace_fd((8, 8, 16), 1.3, dtype=jnp.float32),
                                 coarsest_size=16, impl="lax", **kw)
    smp = MGMCSampler.create(st.shifted_laplace_fd((8, 8, 16), 1.3, device=DEV), coarsest_size=16, **kw)
    assert [o.grid_shape for o in smp.ops] == [tuple(o.grid_shape) for o in jsmp.ops] == [
        (8, 8, 16), (4, 4, 8), (2, 2, 4)]
    assert smp.smoothers[0].has_kernel and not smp.deferred_eligible()
    assert smp.smoothers[1].has_kernel and smp.smoothers[1].route == "fused_galerkin_sweep"
    rs = np.random.RandomState(8)
    x = rs.randn(8, 8, 16).astype(np.float32)
    b = rs.randn(8, 8, 16).astype(np.float32) if with_b else None
    _, got = smp.step(17, torch.from_numpy(x), None if b is None else torch.from_numpy(b))
    want = jsmp.step_with_noise(jnp.asarray(x), None if b is None else jnp.asarray(b),
                                jax.tree_util.tree_map(jnp.asarray, _zeros(jsmp.noise_shapes())))
    assert got.dtype == F32 and _rel(got, want) < 1e-4


def test_f3_linear_prior_takes_the_general_cycle(noise_off, no_chain_kernels):
    """A two-level 3D linear V(1,0) sampler on a float32 FD level 0 has the
    chain kernels' cycle shape, but its transfer is linear: it is not
    deferred-eligible, its keyed step is JAX's general cycle (draws off),
    and neither the step, fmg_init nor create reaches #1, #2 or #3."""
    kw = dict(n_levels=2, n_pre=1, n_post=0)
    smp = MGMCSampler.create(st.shifted_laplace_fd((8, 8, 16), 1.0, device=DEV), **kw)
    jsmp = JaxMGMCSampler.create(jst.shifted_laplace_fd((8, 8, 16), 1.0, dtype=jnp.float32), impl="lax", **kw)
    assert smp.smoothers[0].fd_params is not None and smp.smoothers[0].has_kernel
    assert not smp.deferred_eligible() and not smp._tail_fused_eligible(1)
    agg = MGMCSampler.create(st.shifted_laplace_fd((8, 8, 16), 1.0, device=DEV), coarsening="aggregate", **kw)
    assert agg.deferred_eligible()  # the same cycle under aggregation runs #1
    x = np.random.RandomState(3).randn(8, 8, 16).astype(np.float32)
    _, got = smp.step(4, torch.from_numpy(x), None)
    want = jsmp.step_with_noise(jnp.asarray(x), None,
                                jax.tree_util.tree_map(jnp.asarray, _zeros(jsmp.noise_shapes())))
    assert _rel(got, want) < 1e-4
    with pytest.raises(NotImplementedError):
        smp.step_deferred(0, torch.from_numpy(x), smp.deferred_init(F32), None)
    with mock.patch.object(MGMCSampler, "_fused_tail_cycle", side_effect=AssertionError("tail")), \
            mock.patch.object(MGMCSampler, "_fused_down", side_effect=AssertionError("#3")):
        _, x0 = smp.fmg_init(1, None)
    assert x0.shape == (8, 8, 16) and bool(torch.isfinite(x0).all())


def test_f3_linear_posterior_takes_the_general_cycle(noise_off, no_chain_kernels):
    """The same on an LRC operator: the rank-k matrices are built as JAX
    builds them, but #1 is never probed (no Mb_pv) and the keyed step is
    JAX's general cycle with zero noises."""
    args = (0.1, np.array([[0.3, 0.4, 0.5], [0.6, 0.3, 0.7]]), np.full(2, 0.25), np.ones(2))
    op, f = make_posterior_operator(st.shifted_laplace_fd((8, 8, 16), 1.0, device=DEV), *args)
    jop, jf = jax_make_posterior_operator(jst.shifted_laplace_fd((8, 8, 16), 1.0, dtype=jnp.float32), *args)
    kw = dict(n_levels=2, n_pre=1, n_post=0)
    smp = MGMCSampler.create(op, **kw)
    jsmp = JaxMGMCSampler.create(jop, impl="lax", **kw)
    assert smp.smoothers[0].is_lrc and smp.smoothers[0].has_kernel
    assert smp.lrc_aux is not None and smp.lrc_aux.probe is None
    assert not smp.deferred_eligible() and not smp._lrc_chain_eligible()
    x = np.random.RandomState(4).randn(8, 8, 16).astype(np.float32)
    zeros = jax.tree_util.tree_map(jnp.asarray, _zeros(jsmp.noise_shapes()))
    for tb, jb in ((None, None), (f, jf)):
        _, got = smp.step(5, torch.from_numpy(x), tb)
        want = jsmp.step_with_noise(jnp.asarray(x), jb, zeros)
        assert _rel(got, want) < 1e-4
