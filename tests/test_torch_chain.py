"""The port's IACT diagnostics against the JAX ones, the chain drivers'
bookkeeping, and the package's independence from JAX (CPU)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from parmgmc_tpu.diagnostics.iact import autocorrelation as jax_autocorrelation
from parmgmc_tpu.diagnostics.iact import ess as jax_ess
from parmgmc_tpu.diagnostics.iact import iact as jax_iact
from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.chain import ExplicitNoise, init_chain, sample_chain, sample_moments
from parmgmc_tpu_torch.diagnostics.iact import autocorrelation, ess, iact
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler


# the entry points default to the card; these tests run on the host
DEV = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ar1_chains(n_chains, n, phis, seed=0):
    rs = np.random.RandomState(seed)
    out = np.zeros((n_chains, n))
    for c in range(n_chains):
        e = rs.randn(n)
        for i in range(1, n):
            out[c, i] = phis[c % len(phis)] * out[c, i - 1] + e[i]
    return out


@pytest.mark.parametrize("n", [1000, 1537])
def test_iact_matches_jax(n):
    chains = _ar1_chains(6, n, (0.0, 0.5, 0.9, -0.3))
    rho = autocorrelation(torch.from_numpy(chains)).numpy()
    assert np.abs(rho - np.asarray(jax_autocorrelation(chains))).max() < 1e-10
    for c in chains:
        tau, valid = iact(c)
        tau_j, valid_j = jax_iact(c)
        assert abs(tau - tau_j) < 1e-10 and valid == valid_j
        assert abs(float(ess(c)) - float(jax_ess(c))) < 1e-8
    taus, valids = iact(chains)
    taus_j, valids_j = jax_iact(chains)
    assert np.abs(taus - taus_j).max() < 1e-10 and (valids == valids_j).all()
    # a batch gives what the chains give one at a time
    one = np.array([iact(c)[0] for c in chains])
    assert np.abs(taus - one).max() < 1e-12
    # the window edge cases: a constant-free white chain and a short one
    for c in (np.random.RandomState(3).randn(50), chains[2, :20]):
        assert abs(iact(c)[0] - jax_iact(c)[0]) < 1e-10


def test_keys_split_and_draw_deterministically():
    a, b = keys.split(123)
    assert (a, b) == keys.split(123) and a != b
    assert len(set(keys.split(7, 5))) == 5
    assert 0 <= keys.randint31(a) < 2**31
    g1, g2 = keys.generator(a, "cpu"), keys.generator(a, "cpu")
    assert torch.equal(torch.randn(4, generator=g1), torch.randn(4, generator=g2))


def test_sample_chain_burnin_and_explicit_noise():
    op = shifted_laplace_fd((6, 6, 6), 3.0, torch.float64, device=DEV)
    smp = ExplicitNoise(GibbsSampler.create(op, omega=1.0, sweep="symmetric"))
    st = init_chain(MGMCSampler.create(op, n_levels=1), 4)
    assert st.x.shape == (6, 6, 6)
    b = torch.ones(op.grid_shape, dtype=torch.float64)
    _, all_steps = sample_chain(smp, st, b, 7, extract=torch.mean)
    _, tail = sample_chain(smp, st, b, 4, extract=torch.mean, burnin=3)
    assert torch.equal(all_steps[3:], tail)
    # Welford moments equal the stored stream's moments
    _, xs = sample_chain(smp, st, b, 30, burnin=2)
    _, mean, var = sample_moments(smp, st, b, 30, burnin=2)
    assert torch.allclose(mean, xs.mean(0), rtol=1e-12, atol=1e-12)
    assert torch.allclose(var, xs.var(0), rtol=1e-10, atol=1e-14)


def test_package_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import parmgmc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'parmgmc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'parmgmc_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _words_sampler(posterior):
    """A 16^3 aggregate V(1,0) sampler down to 2^3 (#1, then #2 over levels
    1 and 2 on the prior; #1 and #7 with their low-rank draws on the
    posterior) and its right-hand side."""
    from parmgmc_tpu_torch.models.obs import make_posterior_operator

    op, b = shifted_laplace_fd((16, 16, 16), 1.0, device=DEV), None
    if posterior:
        op, b = make_posterior_operator(op, 0.1, np.array([[0.3, 0.4, 0.5], [0.6, 0.3, 0.7]]),
                                        np.full(2, 0.25), np.ones(2))
    smp = MGMCSampler.create(op, n_pre=1, n_post=0, coarsest_size=8, coarsening="aggregate")
    assert smp.deferred_eligible() and smp.n_levels == 4
    return smp, b


@pytest.mark.parametrize("posterior", [False, True])
def test_keyed_words_are_the_eager_steps_draws(monkeypatch, posterior):
    """MGMCSampler.keyed_words, the one derivation of a step's noise that
    the eager step and a replayed graph share, gives the hash prefixes and
    generator seeds the eager deferred step and the keyed step hand their
    kernel wrappers and generators, value for value and in order; on the
    prior they are also the derivation from the key written out."""
    from parmgmc_tpu_torch import replay
    from parmgmc_tpu_torch.kernels import _noise, mg_sweep, mg_tail
    from parmgmc_tpu_torch.samplers import gibbs

    smp, b = _words_sampler(posterior)
    prefixes, seeds = [], []
    chain, tail, sweep, seeded = (mg_sweep.fused_chain_down_fd, mg_tail.fused_tail_down,
                                  gibbs.fused_rb_gibbs_sweep_fd, keys.seeded)

    def rec_chain(x, b, coeffs, kappa2, hinv2, omega, seed, step, **kw):
        prefixes.append(_noise.hash_prefix(seed, step, _noise.CHAIN_DOMAIN))
        return chain(x, b, coeffs, kappa2, hinv2, omega, seed, step, **kw)

    def rec_tail(bl, params, seed, step, color0, shapes, **kw):
        prefixes.extend(_noise.hash_prefix(seed, step, _noise.TAIL_DOMAIN + li)
                        for li in range(len(shapes) - 1))
        return tail(bl, params, seed, step, color0, shapes, **kw)

    def rec_sweep(x, b, coeffs, kappa2, hinv2, omega, seed, step, *a, **kw):
        prefixes.append(_noise.hash_prefix(seed, step, _noise.SWEEP_DOMAIN))
        return sweep(x, b, coeffs, kappa2, hinv2, omega, seed, step, *a, **kw)

    def rec_seeded(seed, device):
        seeds.append(seed)
        return seeded(seed, device)

    monkeypatch.setattr(mg_sweep, "fused_chain_down_fd", rec_chain)
    monkeypatch.setattr(mg_tail, "fused_tail_down", rec_tail)
    monkeypatch.setattr(gibbs, "fused_rb_gibbs_sweep_fd", rec_sweep)
    monkeypatch.setattr(keys, "seeded", rec_seeded)
    key = 2**40 + 12345
    x = torch.randn(smp.grid_shape, generator=torch.Generator().manual_seed(1))
    words = smp.keyed_words(key)
    assert replay.graphs_for(smp, x, b) is None  # the host's chain stays eager
    next_key, *_ = smp.step_deferred(key, x, smp.deferred_init(torch.float32, x), b)
    assert next_key == words.key == keys.split(key)[0]
    n_launch = 1 + (smp.n_levels - 2 if posterior else 1)
    assert len(prefixes) == smp.n_levels - 1 and len(words.entries) == n_launch + len(seeds)
    assert list(words.prefixes) == prefixes and list(words.seeds) == seeds
    assert len(seeds) == (smp.n_levels if posterior else 1)
    deferred = (prefixes[:], seeds[:])
    prefixes.clear()
    seeds.clear()
    assert smp.step(key, x, b)[0] == words.key
    assert (prefixes, seeds) == deferred
    if not posterior:
        # #1 under split(key)[1], #2 and the coarse draw under what follows
        _, sub = keys.split(key)
        sub, k1, k2 = keys.split(sub, 3)
        want = [_noise.hash_prefix(keys.randint31(k1), keys.randint31(k2), _noise.CHAIN_DOMAIN)]
        _, sub = keys.split(sub)
        sub, k1, k2 = keys.split(sub, 3)
        want += [_noise.hash_prefix(keys.randint31(k1), keys.randint31(k2), _noise.TAIL_DOMAIN + li)
                 for li in range(2)]
        _, kc = keys.split(sub)
        assert prefixes == want and seeds == [keys._splitmix64(kc) >> 1]
