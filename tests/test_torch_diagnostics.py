"""The port's diagnostics against the JAX package (CPU).

* every function of ``diagnostics/rhat.py`` (split chains, rank
  normalisation, split and rank R-hat, mean/bulk/quantile/tail ESS) and
  ``iact.ess_per_sec`` against JAX on the same AR(1) traces, float64, to
  1e-10; pooled draw counts even (the median averages the two middle
  draws) and odd, ties in the folded draws included;
* ``gelman_rubin``, ``sample_covariance`` and
  ``covariance_error_trajectory`` against JAX;
* ``sample_until_converged`` by statistics on ex7's problem
  (``shifted_laplace_fd((9, 9), 1)``, ``n_levels=2``, b = 1), both
  methods: it converges, the traces keep their overdispersed start, and
  the pooled mean QOI of the last half lies within Monte Carlo error of
  mean(A^{-1} b).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.diagnostics import iact as jiact
from parmgmc_tpu.diagnostics import rhat as jrhat
from parmgmc_tpu.diagnostics import stats as jstats
from parmgmc_tpu_torch.diagnostics import iact, rhat, stats
from parmgmc_tpu_torch.diagnostics.stats import sample_until_converged
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

# the entry points default to the card; these tests run on the host
DEV = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ar1(rho, m, n, seed):
    rng = np.random.default_rng(seed)
    innov = np.sqrt(1 - rho**2) * rng.standard_normal((m, n))
    x = np.empty((m, n))
    x[:, 0] = rng.standard_normal(m)
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + innov[:, t]
    return x


def _close(got, want, tol=1e-10):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, (got, want)


# (chains, n): 4 x 300 even pooled (1200), 3 x 301 odd pooled (903), one
# chain of odd length (split drops a draw), AR(1) at two correlations
TRACES = [(0.5, 4, 300, 1), (0.8, 3, 301, 2), (0.3, 1, 257, 3), (0.9, 8, 64, 4)]


@pytest.mark.parametrize("rho,m,n,seed", TRACES)
def test_rhat_module_matches_jax(rho, m, n, seed):
    x = _ar1(rho, m, n, seed) + 0.3
    t = torch.from_numpy(x)
    _close(rhat.split_chains(t), jrhat.split_chains(jnp.asarray(x)), 0.0)
    _close(rhat.rank_normalize(t), jrhat.rank_normalize(jnp.asarray(x)))
    for name in ("split_rhat", "rhat_rank", "ess_mean", "ess_bulk", "ess_tail"):
        got, want = getattr(rhat, name)(t), getattr(jrhat, name)(x)
        assert isinstance(got, float)
        _close(got, want)
    for q in (0.05, 0.5, 0.95):
        _close(rhat.ess_quantile(t, q), jrhat.ess_quantile(x, q))
    # numpy input takes the same path
    _close(rhat.rhat_rank(x), jrhat.rhat_rank(x))


def test_median_of_an_even_count_is_the_midpoint():
    """An even pooled count folds about the mean of the two middle draws
    (jnp.median), not the lower one (torch.median); the two middle draws
    then tie in the folded draws and the stable ranks must agree too."""
    x = np.array([[0.0, 1.0, 5.0, 6.0], [2.0, 3.0, 9.0, 4.0]])
    assert float(rhat._median(torch.from_numpy(x))) == float(jnp.median(x)) == 3.5
    assert float(torch.median(torch.from_numpy(x))) == 3.0  # the trap
    _close(rhat.rhat_rank(x), jrhat.rhat_rank(x))
    folded = np.abs(x - 3.5)
    _close(rhat.rank_normalize(folded), jrhat.rank_normalize(jnp.asarray(folded)))


def test_quantile_matches_jax_linear():
    x = np.random.default_rng(5).standard_normal((3, 101))
    for q in (0.0, 0.05, 0.37, 0.5, 0.95, 1.0):
        assert float(rhat._quantile(torch.from_numpy(x), q)) == float(jnp.quantile(x, q))


def test_ess_mean_constant_input():
    assert rhat.ess_mean(np.ones((3, 100))) == jrhat.ess_mean(np.ones((3, 100))) == 300.0


@pytest.mark.parametrize("batch", [False, True])
def test_ess_per_sec_matches_jax(batch):
    x = _ar1(0.6, 3, 2000, 6)
    x = x if batch else x[0]
    _close(iact.ess_per_sec(torch.from_numpy(x), 2.5), jiact.ess_per_sec(x, 2.5))


def test_stats_match_jax():
    rng = np.random.default_rng(7)
    vals = _ar1(0.4, 5, 200, 8)
    _close(stats.gelman_rubin(torch.from_numpy(vals)), jstats.gelman_rubin(jnp.asarray(vals)))
    s = rng.standard_normal((40, 6))
    _close(stats.sample_covariance(torch.from_numpy(s)), jstats.sample_covariance(jnp.asarray(s)))
    samples = rng.standard_normal((12, 5, 6))
    M = rng.standard_normal((6, 6))
    A = M @ M.T + 6.0 * np.eye(6)
    _close(stats.covariance_error_trajectory(torch.from_numpy(samples), torch.from_numpy(A)),
           jstats.covariance_error_trajectory(jnp.asarray(samples), jnp.asarray(A)))


@pytest.mark.parametrize("method", ["classic", "rank"])
def test_sample_until_converged_ex7(method):
    """ex7's problem in float64 (2D: the explicit-noise route, no kernel):
    8 overdispersed chains converge well inside max_steps, step 0 keeps
    the overdispersed start, and the pooled mean QOI of the last half of
    every chain lies within 5 standard errors of mean(A^{-1} 1)."""
    op = shifted_laplace_fd((9, 9), 1.0, dtype=torch.float64, device=DEV)
    smp = MGMCSampler.create(op, n_levels=2)
    b = torch.ones(op.grid_shape, dtype=torch.float64)
    trace, steps, r = sample_until_converged(smp, b, torch.mean, n_chains=8, check_every=50,
                                             max_steps=2000, method=method)
    assert r < 1.05 and steps < 2000
    assert trace.shape == (8, steps) and np.isfinite(trace).all()
    A = op.to_dense().numpy()
    exact = np.linalg.solve(A, np.ones(op.n)).mean()
    # the overdispersed start (x0 ~ 1e3 N(0, I)) shows in the first draws
    assert np.abs(trace[:, 0] - exact).max() > 1.0
    tail = trace[:, steps // 2:]
    taus, _ = iact.iact(tail)
    w = np.full(op.n, 1.0 / op.n)
    var_q = w @ np.linalg.solve(A, w)  # Var mean(x) = 1^T A^{-1} 1 / N^2
    se = np.sqrt(np.maximum(taus, 1.0).mean() * var_q / tail.size)
    assert abs(tail.mean() - exact) < 5 * se, (tail.mean(), exact, se)
