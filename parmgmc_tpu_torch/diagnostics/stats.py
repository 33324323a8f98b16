"""Cross-chain statistics (port of ``parmgmc_tpu.diagnostics.stats``):
the sample-covariance error trajectory against the exact covariance
A^{-1}, the Gelman-Rubin R-hat, and the ex7 flow
:func:`sample_until_converged` (overdispersed chains until R-hat drops
below a tolerance).
"""

from __future__ import annotations

import numpy as np
import torch

from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.diagnostics.iact import _as_tensor

__all__ = [
    "sample_covariance",
    "covariance_error_trajectory",
    "gelman_rubin",
    "sample_until_converged",
]


def sample_covariance(samples) -> torch.Tensor:
    """Unbiased sample covariance over the leading axis: (m, n) -> (n, n)."""
    samples = _as_tensor(samples)
    d = samples - samples.mean(dim=0)
    return d.T @ d / (samples.shape[0] - 1)


def covariance_error_trajectory(samples, A_dense) -> torch.Tensor:
    """errs[j] = ||Cov_j - A^{-1}||_F / ||A^{-1}||_F, Cov_j the covariance
    across chains of sample j: ``samples`` is (chains, steps, n)."""
    samples, A_dense = _as_tensor(samples), _as_tensor(A_dense)
    n = A_dense.shape[0]
    Q = torch.linalg.solve(A_dense, torch.eye(n, dtype=A_dense.dtype, device=A_dense.device))
    per_step = samples.transpose(0, 1)  # (steps, chains, n)
    d = per_step - per_step.mean(dim=1, keepdim=True)
    C = d.transpose(1, 2) @ d / (samples.shape[0] - 1)
    return torch.linalg.matrix_norm(C - Q) / torch.linalg.matrix_norm(Q)


def gelman_rubin(vals) -> torch.Tensor:
    """R-hat of scalar chains (chains, n), as the reference's ex7:
    B = n/(chains-1) sum (mean_i - mean)^2, W = the mean within-chain
    variance, R = ((n-1)/n W + B/n) / W."""
    vals = _as_tensor(vals)
    chains, n = vals.shape
    means = vals.mean(dim=1)
    B = n / (chains - 1.0) * ((means - means.mean()) ** 2).sum()
    W = (((vals - means[:, None]) ** 2).sum(dim=1) / (n - 1.0)).mean()
    return ((n - 1.0) / n * W + B / n) / W


def sample_until_converged(sampler, b, qoi, n_chains: int = 8, check_every: int = 50,
                           rhat_tol: float = 1.05, max_steps: int = 100_000,
                           overdispersion: float = 1e3, seed: int = 0, method: str = "classic"):
    """(qoi traces (chains, steps) as numpy, steps, rhat): overdispersed
    chains until R-hat < ``rhat_tol`` (the ex7 flow).

    Chain c starts at ``overdispersion`` N(0, I) and advances through the
    sampler's own keyed step, one chain at a time
    (:func:`~parmgmc_tpu_torch.chain.multi_chain`), so kernel samplers run
    their kernels.  Every ``check_every`` steps the scalar QOI traces so
    far come to the host and R-hat is taken over all of them:
    ``method="classic"`` is ex7's moment R-hat, ``"rank"`` the
    rank-normalised split-R-hat with folding
    (:func:`~parmgmc_tpu_torch.diagnostics.rhat.rhat_rank`).  The keys
    split ``seed`` as JAX splits its key (C ways, then each into init and
    chain); the draws differ from JAX's (another generator), the law is
    the same."""
    from parmgmc_tpu_torch.chain import ChainState, multi_chain, sample_chain

    if method == "rank":
        from parmgmc_tpu_torch.diagnostics.rhat import rhat_rank as _rhat
    elif method == "classic":
        _rhat = lambda v: float(gelman_rubin(v))  # noqa: E731
    else:
        raise ValueError(f"method must be 'classic' or 'rank', got {method!r}")

    xs, chain_keys = [], []
    for k in keys.split(seed, n_chains):
        kinit, kchain = keys.split(k)
        g = keys.generator(kinit, sampler.device)
        xs.append(overdispersion * torch.randn(tuple(sampler.grid_shape), generator=g,
                                               dtype=sampler.dtype, device=sampler.device))
        chain_keys.append(kchain)
    states = ChainState(x=torch.stack(xs), key=tuple(chain_keys))
    del xs
    run = multi_chain(lambda st: sample_chain(sampler, st, b, check_every, extract=qoi), n_chains)

    traces = []
    steps = 0
    rhat = float("inf")
    while steps < max_steps:
        states, q = run(states)
        traces.append(q.cpu().numpy())
        steps += check_every
        rhat = _rhat(np.concatenate(traces, axis=1))
        if rhat < rhat_tol:
            break
    return np.concatenate(traces, axis=1), steps, rhat
