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
