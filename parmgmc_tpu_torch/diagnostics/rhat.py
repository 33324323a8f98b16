"""Rank-normalised split-R-hat and bulk/tail ESS (port of
``parmgmc_tpu.diagnostics.rhat``; Vehtari, Gelman, Simpson, Carpenter,
Buerkner, Bayesian Analysis 2021).

* ``split_rhat`` -- R-hat on half-split chains,
* ``rhat_rank``  -- max of split-R-hat over rank-normalised draws (bulk)
  and rank-normalised draws folded about the median (tails),
* ``ess_mean``   -- multi-chain ESS with the cross-chain variance term
  and Geyer's initial monotone sequence,
* ``ess_bulk`` / ``ess_tail`` / ``ess_quantile``.

Draws are ``(chains, n)`` tensors or arrays.  Ranking and the FFT
autocovariances run in torch on the draws' device; the Geyer window scan
runs on the host in float64, as in the JAX package.  Three details keep
the results equal to JAX's: the median averages the two middle draws of
an even count (``torch.median`` returns the lower one), quantiles
interpolate linearly as ``jnp.quantile`` does, through one sort (which
``torch.quantile``, limited to 2^24 elements, is not), and ranks come
from one stable argsort of the pooled draws.
"""

from __future__ import annotations

import numpy as np
import torch

from parmgmc_tpu_torch.diagnostics.iact import _as_tensor, _next_pow_two

__all__ = [
    "split_chains",
    "rank_normalize",
    "split_rhat",
    "rhat_rank",
    "ess_mean",
    "ess_bulk",
    "ess_tail",
    "ess_quantile",
]


def _as_2d(vals) -> torch.Tensor:
    vals = _as_tensor(vals)
    return vals.reshape(1, -1) if vals.ndim < 2 else vals


def split_chains(vals) -> torch.Tensor:
    """(chains, n) -> (2 chains, n // 2): each chain split into halves
    (an odd last draw is dropped, as in Stan)."""
    vals = _as_2d(vals)
    m, n = vals.shape
    half = n // 2
    return vals[:, : 2 * half].reshape(m * 2, half)


def rank_normalize(vals) -> torch.Tensor:
    """Pooled draws replaced by normal scores ndtri((r - 3/8) / (S + 1/4)),
    r the rank among all S draws of all chains (Blom offsets)."""
    vals = _as_2d(vals)
    flat = vals.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(1, flat.numel() + 1, device=flat.device)
    z = torch.special.ndtri((ranks.to(vals.dtype) - 0.375) / (flat.numel() + 0.25))
    return z.reshape(vals.shape)


def _median(vals: torch.Tensor) -> torch.Tensor:
    """The median of all draws; the mean of the two middle ones for an
    even count (``jnp.median``: (lo + hi) * 0.5)."""
    s = torch.sort(vals.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _quantile(vals: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of all draws by linear interpolation, in
    ``jnp.quantile``'s arithmetic: lo (1 - w) + hi w at q (S - 1), in
    float64, rounded to the draws' dtype."""
    s = torch.sort(vals.reshape(-1)).values
    pos = q * (s.numel() - 1)
    lo = int(np.floor(pos))
    hi = min(int(np.ceil(pos)), s.numel() - 1)
    w = pos - lo
    return (s[lo].double() * (1.0 - w) + s[hi].double() * w).to(s.dtype)


def split_rhat(vals) -> float:
    """Gelman-Rubin R-hat on half-split chains (n >= 4)."""
    from parmgmc_tpu_torch.diagnostics.stats import gelman_rubin

    return float(gelman_rubin(split_chains(vals)))


def rhat_rank(vals) -> float:
    """Rank-normalised split-R-hat: the max of the bulk term and the tail
    term (draws folded about the median, |x - median(x)|)."""
    vals = _as_2d(vals)
    bulk = split_rhat(rank_normalize(vals))
    tail = split_rhat(rank_normalize(torch.abs(vals - _median(vals))))
    return max(bulk, tail)


def _chain_autocovariance(vals: torch.Tensor) -> torch.Tensor:
    """Per-chain biased autocovariance (divided by n), by an FFT
    zero-padded to 2 next_pow_two(n)."""
    n = vals.shape[-1]
    xc = vals - vals.mean(dim=-1, keepdim=True)
    f = torch.fft.fft(xc, n=2 * _next_pow_two(n), dim=-1)
    return torch.fft.ifft(f * torch.conj(f), dim=-1).real[..., :n] / n


def ess_mean(vals) -> float:
    """Multi-chain ESS of the mean (the BDA3 / Stan estimator):
    rho_t = 1 - (W - mean_m acov_{m,t}) / var_plus, var_plus = W (n-1)/n
    + B/n, the lag sum cut at Geyer's initial positive sequence and made
    monotone.  A constant input gives chains * n."""
    vals = _as_2d(vals)
    m, n = vals.shape
    acov = _chain_autocovariance(vals).cpu().numpy().astype(np.float64)
    chain_var = acov[:, 0] * n / (n - 1.0)
    W = float(np.mean(chain_var))
    mean_acov = np.mean(acov, axis=0)
    if m > 1:
        B_over_n = float(np.var(vals.mean(dim=-1).cpu().numpy().astype(np.float64), ddof=1))
    else:
        B_over_n = 0.0
    var_plus = W * (n - 1.0) / n + B_over_n
    if var_plus <= 0.0 or not np.isfinite(var_plus):
        return float(m * n)
    rho = 1.0 - (W - mean_acov) / var_plus
    # pair sums P_k = rho_{2k+1} + rho_{2k+2}, cut at the first negative
    # pair and made non-increasing
    n_pairs = (n - 1) // 2
    P = rho[1 : 2 * n_pairs + 1 : 2] + rho[2 : 2 * n_pairs + 2 : 2]
    running_min = np.inf
    s = 0.0
    for Pk in P:
        if Pk < 0.0:
            break
        running_min = min(running_min, float(Pk))
        s += running_min
    tau = max(2.0 * (1.0 + s) - 1.0, 1e-12)
    return float(m * n / tau)


def ess_bulk(vals) -> float:
    """Bulk ESS: ess_mean of the rank-normalised split chains."""
    return ess_mean(rank_normalize(split_chains(vals)))


def ess_quantile(vals, q: float) -> float:
    """ESS of the q-quantile: ess_mean of the split indicator I(x <= q-hat)."""
    vals = _as_2d(vals)
    ind = (vals <= _quantile(vals, q)).to(vals.dtype)
    return ess_mean(split_chains(ind))


def ess_tail(vals) -> float:
    """Tail ESS: the smaller of the 5 % and 95 % quantile ESS."""
    return min(ess_quantile(vals, 0.05), ess_quantile(vals, 0.95))
