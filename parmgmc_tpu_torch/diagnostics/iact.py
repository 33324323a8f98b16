"""Autocorrelation and integrated autocorrelation time (port of
``parmgmc_tpu.diagnostics.iact``).

* ACF by a zero-padded (2 * nextpow2(n)) FFT round trip,
* tau(w) = 2 * cumsum(rho)[w] - 1 with the emcee/Sokal automatic window
  w = min{ i : i >= c * tau_i }, c = 5,
* validity flag 500 * tau <= n.

The window search runs over a batch of chains at once (the JAX version
loops over chains in Python).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["autocorrelation", "iact", "ess", "ess_per_sec"]


def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def autocorrelation(x) -> torch.Tensor:
    """Normalised ACF of chains along the last axis, rho[..., 0] = 1."""
    x = _as_tensor(x)
    n = x.shape[-1]
    N = _next_pow_two(n)
    xc = x - x.mean(dim=-1, keepdim=True)
    f = torch.fft.fft(xc, n=2 * N, dim=-1)
    acov = torch.fft.ifft(f * torch.conj(f), dim=-1).real[..., :n]
    return acov / acov[..., :1]


def iact(x, c: int = 5):
    """(tau, valid): IACT with the emcee window.  A 1D chain gives
    (float, bool); a batch (chains in the leading dims) gives numpy arrays
    of the flattened chains."""
    x = _as_tensor(x)
    squeeze = x.ndim == 1
    x2 = x.reshape(-1, x.shape[-1])
    n = x2.shape[-1]
    taus = 2.0 * torch.cumsum(autocorrelation(x2), dim=-1) - 1.0
    idx = torch.arange(n, device=taus.device)
    below = idx < c * taus  # window not yet reached
    reached = ~below
    first = torch.argmax(reached.to(torch.int8), dim=-1)
    w = torch.where(
        below.any(dim=-1),
        torch.where(reached.any(dim=-1), first, torch.zeros_like(first)),
        torch.full_like(first, n - 1),
    )
    out = torch.gather(taus, 1, w[:, None])[:, 0].cpu().numpy().astype(np.float64)
    valid = 500.0 * out <= n
    if squeeze:
        return float(out[0]), bool(valid[0])
    return out, valid


def ess(x, c: int = 5):
    """Effective sample size n / max(tau, 1) of a scalar chain."""
    x = _as_tensor(x)
    tau, _ = iact(x, c=c)
    return x.shape[-1] / np.maximum(tau, 1.0)


def ess_per_sec(x, wall_seconds: float, c: int = 5):
    """Effective samples per second of wall time: :func:`ess` over
    ``wall_seconds``."""
    return ess(x, c=c) / wall_seconds
