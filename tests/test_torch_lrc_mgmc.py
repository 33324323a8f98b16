"""The port's posterior MGMC chain against the JAX package (CPU).

The JAX side runs as its own tests run it (``tests/test_lrc_fused.py``):
``impl="fused_fd"`` with the level-0 chain kernel replaced by the lax
stand-in ``_fake_chain_down`` where the kernel route is needed, the plain
``step_with_noise`` otherwise.  The port runs its kernels' twins.

* the LRC hierarchy (B_c = P^T B and the window views) and the rank-k
  matrices of the chain step (RABb, H, Bb_colsum), and the probed
  responses of the chain kernel (Mb, RB and their union packs): the
  same windows, values to 1e-4;
* the explicit-noise cycle against JAX in float64 (1e-12) and the exact
  invariance identity (< 1e-10);
* the keyed posterior step with every draw off against JAX
  ``step_with_noise`` with zero noises, on the probed route (with and
  without the union packs; forward, and backward with them) and on the
  b_eff route, b = f and None (float32, 1e-4), and with its draws on against its materialised form
  (``testing.lrc_chain_oracle``, 1e-5);
* the deferred carry's B^T P z against JAX's ``_bt_carry``, and the
  deferred posterior chain against ``sample_chain`` from a nonzero start
  (3e-4, JAX's own bound);
* the probe's refusals: a warning where it keeps the b_eff route, an
  error for a zero column or a kernel that ignores b;
* a short keyed chain's moments against the dense posterior mean.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu.samplers.mgmc import build_hierarchy as jax_build_hierarchy
from parmgmc_tpu_torch import convert
from parmgmc_tpu_torch.chain import init_chain, sample_chain, sample_chain_deferred, sample_moments
from parmgmc_tpu_torch.kernels import mg_sweep, rb_gibbs
from parmgmc_tpu_torch.models.obs import make_posterior_operator
from parmgmc_tpu_torch.operators import lrc
from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.samplers import gibbs, mgmc
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler, build_hierarchy
from parmgmc_tpu_torch.testing import invariance_error, lrc_chain_oracle
from tests.test_lrc_fused import _fake_chain_down
from tests.test_lrc_fused import make_posterior as jax_make_posterior

# the entry points default to the card; these tests run on the host
DEV = "cpu"
F32, F64 = torch.float32, torch.float64
# tests/test_lrc_fused.py's problem: a grid the JAX fused smoother takes
GRID = (8, 16, 128)
COORDS = np.array([[0.3, 0.4, 0.5], [0.6, 0.3, 0.2], [0.5, 0.7, 0.8]])
V10 = dict(n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate")
ROUTES = ("union", "split", "b_eff")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _starts(ps):
    return tuple(tuple(int(v) for v in st) for st in np.asarray(ps))


def _problem(dtype, grid=GRID, coords=COORDS, radius=0.15, sigma2=0.1):
    """The port's operator and f of tests/test_lrc_fused.py's problem."""
    k = coords.shape[0]
    return make_posterior_operator(shifted_laplace_fd(grid, 1.0, dtype, device=DEV), sigma2,
                                   coords, np.full(k, radius), np.ones(k))


def _sampler(op, jsmp, **kw):
    """The port's sampler over its own hierarchy of ``op`` with the JAX
    sampler's coarse factors."""
    ops, _ = build_hierarchy(op, coarsest_size=128, coarsening="aggregate")
    assert [o.grid_shape for o in ops] == [tuple(o.grid_shape) for o in jsmp.ops]
    return convert.mgmc_sampler(ops, np.asarray(jsmp.coarse.L), np.asarray(jsmp.coarse.Li),
                                device=DEV, **kw)


def _unpacked(union):
    """The same stacks without their pack: applied one at a time."""
    return dataclasses.replace(union, vals=None, starts=None)


def _route(smp, route):
    """``smp`` on one route of the posterior chain step: the probed
    responses with the union packs, without them, or none (b_eff)."""
    aux = smp.lrc_aux
    probe = aux.probe
    assert probe is not None and probe.coarse.packed and probe.fine.packed
    if route == "split":
        probe = dataclasses.replace(probe, coarse=_unpacked(probe.coarse), fine=_unpacked(probe.fine))
    elif route == "b_eff":
        probe = None
    return dataclasses.replace(smp, lrc_aux=dataclasses.replace(aux, probe=probe))


def test_lrc_hierarchy_matches_jax():
    op, _ = _problem(F64)
    jop, _ = jax_make_posterior(dtype=jnp.float64)
    ops, _ = build_hierarchy(op, coarsest_size=128, coarsening="aggregate")
    jops, _ = jax_build_hierarchy(jop, coarsest_size=128, coarsening="aggregate")
    assert [o.grid_shape for o in ops] == [tuple(o.grid_shape) for o in jops] == [
        (8, 16, 128), (4, 8, 64), (2, 4, 32)]
    for o, jo in zip(ops, jops):
        assert isinstance(o, LRCOperator) and torch.equal(o.sigma_inv, torch.tensor(np.asarray(jo.sigma_inv)))
        assert _rel(o.B, jo.B) < 1e-12
        assert o.cols.windowed == (jo.patch_vals is not None)
        if o.cols.windowed:
            assert o.cols.starts == _starts(jo.patch_starts) and _rel(o.cols.vals, jo.patch_vals) < 1e-12
        x = np.random.RandomState(1).randn(*o.grid_shape)
        assert _rel(o.base.apply(torch.from_numpy(x)), jo.base.apply(jnp.asarray(x))) < 1e-12


@pytest.fixture
def jax_probed(monkeypatch):
    """The JAX posterior sampler in float32 on the kernel route, its chain
    kernel replaced by the lax stand-in (its probes run that too)."""
    monkeypatch.setattr(JaxMGMCSampler, "_fused_chain_down", _fake_chain_down)
    jop, jf = jax_make_posterior()
    jsmp = JaxMGMCSampler.create(jop, impl="fused_fd", **V10)
    assert jsmp._lrc_chain_eligible() and {"Mb_pv", "CW_pv", "FW_pv"} <= set(jsmp.lrc_aux)
    return jsmp, jf


def test_lrc_aux_and_probes_match_jax(jax_probed):
    jsmp, _ = jax_probed
    op, _ = _problem(F32)
    smp = MGMCSampler.create(op, **V10)
    assert smp._lrc_chain_eligible() and smp.deferred_eligible()
    aux, jaux = smp.lrc_aux, jsmp.lrc_aux
    p = aux.probe
    # the record's fields under the JAX dict's keys
    mine = {"RABb": aux.RABb, "H": aux.H, "Bb_colsum": aux.Bb_colsum, "BtMb": p.BtMb,
            "Mb_colsum": p.Mb_colsum}
    for name, stack in (("Mb", p.Mb), ("RB", p.RB), ("CW", p.coarse), ("FW", p.fine)):
        mine[f"{name}_pv"], mine[f"{name}_ps"] = stack.vals, stack.starts
    assert set(mine) == set(jaux)
    for name in ("RABb", "H", "Bb_colsum"):
        assert _rel(mine[name], jaux[name]) < 1e-5, name
    # the kernel's responses: the same compact supports, so the same windows
    for name in ("Mb", "RB", "CW", "FW"):
        assert mine[f"{name}_ps"] == _starts(jaux[f"{name}_ps"]), name
        assert mine[f"{name}_pv"].shape == jaux[f"{name}_pv"].shape, name
        assert _rel(mine[f"{name}_pv"], jaux[f"{name}_pv"]) < 1e-4, name
    for name in ("BtMb", "Mb_colsum"):
        assert _rel(mine[name], jaux[name]) < 1e-4, name


def _numpy_noises(shapes, rs, dtype=np.float64):
    if isinstance(shapes, tuple):
        return rs.randn(*shapes).astype(dtype)
    if isinstance(shapes, dict):
        return {k: _numpy_noises(v, rs, dtype) for k, v in shapes.items()}
    return [_numpy_noises(v, rs, dtype) for v in shapes]


CYCLES = {"V10": dict(n_pre=1, n_post=0), "V11sym": dict(n_pre=1, n_post=1, sweep="symmetric", omega=1.2)}


@pytest.mark.parametrize("cycle", list(CYCLES))
def test_lrc_step_with_noise_matches_jax(cycle):
    kw = CYCLES[cycle]
    jop, jf = jax_make_posterior(dtype=jnp.float64)
    jsmp = JaxMGMCSampler.create(jop, coarsest_size=128, coarsening="aggregate", impl="lax", **kw)
    op, f = _problem(F64)
    smp = _sampler(op, jsmp, **kw)
    assert smp.noise_shapes() == jsmp.noise_shapes()
    rs = np.random.RandomState(5)
    x = rs.randn(*GRID)
    noises = _numpy_noises(smp.noise_shapes(), rs)
    for b, jb in ((f, jf), (None, None)):
        got = smp.step_with_noise(torch.from_numpy(x), b, convert.tree(noises, DEV))
        want = jsmp.step_with_noise(jnp.asarray(x), jb, jax.tree_util.tree_map(jnp.asarray, noises))
        assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("case", ["balls_3d", "dense_2d"])
@pytest.mark.parametrize("cycle", list(CYCLES))
def test_lrc_mgmc_invariance(case, cycle):
    if case == "balls_3d":
        op, f = _problem(F64, grid=(4, 8, 8), coords=COORDS[:2], radius=0.3)
        assert op.cols.windowed
    else:  # random dense columns, as tests/test_sampler_exactness.py
        rs = np.random.RandomState(42)
        base = shifted_laplace_fd((6, 6), 1.5, F64, device=DEV)
        op = LRCOperator(base, torch.from_numpy(rs.randn(6, 6, 3)), torch.tensor([2.0, 0.5, 1.3], dtype=F64))
        f = torch.from_numpy(np.sin(np.arange(36.0)).reshape(6, 6))
    smp = MGMCSampler.create(op, coarsest_size=8, coarsening="aggregate", **CYCLES[cycle])
    assert smp.n_levels == 2 and isinstance(smp.ops[1], LRCOperator)
    for rhs in (f, None):
        mean_err, cov_err = invariance_error(smp, op, rhs)
        assert mean_err < 1e-10 and cov_err < 1e-10, (mean_err, cov_err)


@pytest.fixture
def draws_off(monkeypatch):
    """The keyed posterior step with every draw switched off: the chain
    kernel's and the sweep kernels' noise, the low-rank draw w and the
    coarse Cholesky draw."""
    monkeypatch.setattr(mg_sweep, "fused_chain_down_fd",
                        functools.partial(mg_sweep.fused_chain_down_fd, with_noise=False))
    monkeypatch.setattr(gibbs, "fused_rb_gibbs_sweep_fd",
                        functools.partial(rb_gibbs.fused_rb_gibbs_sweep_fd, with_noise=False))
    monkeypatch.setattr(gibbs, "_lowrank_draw", lambda key, scale, n: scale.new_zeros((n, scale.shape[0])))

    def zero_coarse_step(self, cur, x, b, aux=None):
        cur.generator(self.L.device)  # the draw's word, unused
        eta = torch.zeros(self.n, dtype=self.dtype, device=self.L.device)
        return self.step_with_noise(x, b, [{"eta": eta}], aux)

    monkeypatch.setattr(CholeskySampler, "step_from", zero_coarse_step)


def _zeros(shapes):
    if isinstance(shapes, tuple):
        return jnp.zeros(shapes, jnp.float32)
    if isinstance(shapes, dict):
        return {k: _zeros(v) for k, v in shapes.items()}
    return [_zeros(v) for v in shapes]


@pytest.mark.parametrize("route,sweep", [(r, "forward") for r in ROUTES] + [("union", "backward")])
def test_keyed_posterior_step_without_noise_is_the_explicit_step(draws_off, route, sweep):
    jop, jf = jax_make_posterior()
    jsmp = JaxMGMCSampler.create(jop, impl="lax", sweep=sweep, **V10)
    op, f = _problem(F32)
    smp = _route(_sampler(op, jsmp, n_pre=1, n_post=0, sweep=sweep), route)
    assert smp._lrc_chain_eligible()
    x = np.random.RandomState(8).randn(*GRID).astype(np.float32)
    for b, jb in ((f, jf), (None, None)):
        _, got = smp.step(17, torch.from_numpy(x), b)
        want = jsmp.step_with_noise(jnp.asarray(x), jb, _zeros(jsmp.noise_shapes()))
        assert got.dtype == F32 and _rel(got, want) < 1e-4, (route, b is None)


@pytest.mark.parametrize("route", ROUTES)
def test_lrc_chain_step_is_the_materialised_oracle(route):
    """With the draws on: the same kernel calls under the same keys, the
    rank-k algebra against b_eff formed on the grid, the Woodbury
    correction and the LRC residual (tests/test_lrc_fused.py's check,
    and chip_smoke.py's on the card)."""
    op, f = _problem(F32)
    smp = _route(MGMCSampler.create(op, **V10), route)
    x = torch.from_numpy(np.random.RandomState(1).randn(*GRID).astype(np.float32))
    for b in (f, None):
        _, got = smp.step(3, x, b)
        assert _rel(got, lrc_chain_oracle(smp, 3, x, b)) < 1e-5, (route, b is None)


def test_deferred_carry_matches_jax(jax_probed):
    jsmp, _ = jax_probed
    op, _ = _problem(F32)
    smp = MGMCSampler.create(op, **V10)
    rs = np.random.RandomState(3)
    zc = rs.randn(4, 8, 64).astype(np.float32)
    zx2 = np.repeat(zc, 2, axis=-1)  # JAX's whole-plane carry: lanes duplicated
    assert jsmp.deferred_layout() == "zx2"
    x0 = rs.randn(*GRID).astype(np.float32)
    jcarry = jsmp.deferred_init(jnp.float32, jnp.asarray(x0))
    jcarry = (jnp.asarray(zx2), jcarry[1])
    z, btx = convert.deferred_carry_from_jax(jcarry, "zx2", DEV)
    assert torch.equal(z, torch.from_numpy(zc))
    assert _rel(smp._bt_carry(z), jsmp._bt_carry(jnp.asarray(zx2))) < 1e-5
    pz, pbtx = smp.deferred_init(F32, torch.from_numpy(x0))
    assert pz.shape == (4, 8, 64) and not pz.any() and _rel(pbtx, btx) < 1e-5
    assert not smp.deferred_init(F32)[1].any()


@pytest.mark.parametrize("route", ["union", "b_eff"])
def test_deferred_posterior_chain_is_the_plain_chain(route):
    op, f = _problem(F32)
    smp = _route(MGMCSampler.create(op, **V10), route)
    x0 = torch.from_numpy(np.random.RandomState(4).randn(*GRID).astype(np.float32))
    st = init_chain(smp, 4, x0)
    for b in (f, None):
        sa, qa = sample_chain(smp, st, b, 6, extract=torch.mean)
        sb, qb = sample_chain_deferred(smp, st, b, 6)
        assert _rel(sb.x, sa.x) < 3e-4, (route, b is None)
        assert (qb - qa).abs().max().item() <= 1e-6 + 3e-4 * qa.abs().max().item()


def test_probe_raises_or_warns_instead_of_falling_back_silently(monkeypatch):
    """attach_chain_b_response: responses too wide for the fill keep the
    b_eff route with a warning; a zero column of B and a kernel that
    ignores its b stream raise."""
    op, _ = _problem(F32)
    smp = MGMCSampler.create(op, **V10)
    bare = dataclasses.replace(smp, lrc_aux=dataclasses.replace(smp.lrc_aux, probe=None))
    with pytest.warns(RuntimeWarning, match="b_eff route"):
        kept = mgmc.attach_chain_b_response(bare, max_fill=1e-3)
    assert kept is bare and kept._lrc_chain_eligible()
    B = op.B.clone()
    B[..., 1] = 0
    pv = op.cols.vals.clone()
    pv[1] = 0
    zero = LRCOperator(op.base, B, op.sigma_inv, cols=lrc.Columns(B, pv, op.cols.starts))
    with pytest.raises(ValueError, match="column 1 of B is zero"):
        MGMCSampler.create(zero, **V10)
    monkeypatch.setattr(mg_sweep, "fused_chain_down_fd",
                        lambda x, b, *a, **kw: mg_sweep.fused_chain_down_fd_reference(x, None, *a, **kw))
    with pytest.raises(RuntimeError, match="no response to column 0"):
        mgmc.attach_chain_b_response(bare)


def test_keyed_posterior_moments():
    """The keyed chain (twins) targets N(A_post^{-1} f, A_post^{-1}): its
    mean against the dense posterior mean, tests/test_lrc_fused.py's gates."""
    grid = (8, 16, 32)
    op, f = _problem(F32, grid=grid, radius=0.12)
    smp = MGMCSampler.create(op, n_pre=1, n_post=0, coarsest_size=32, coarsening="aggregate")
    assert smp._lrc_chain_eligible() and smp.lrc_aux.probe is not None
    n = 3000
    _, mean, var = sample_moments(smp, init_chain(smp, 17), f, n, burnin=50)
    A = op.to_dense().double()
    mu = torch.linalg.solve(A, f.double().reshape(-1))
    se = torch.sqrt(var.double().reshape(-1) / n)
    z = (mean.double().reshape(-1) - mu).abs() / se.clamp(min=1e-12)
    assert z.max() < 10.0 and z.mean() < 2.5, (z.max().item(), z.mean().item())
