"""Frozen metric arithmetic: the integrated autocorrelation time and the
request tail.  Kept here, apart from the program, so that no later change
to the program moves the yardstick."""

from __future__ import annotations

import math

import numpy as np


def iact(x, c: int = 5) -> float:
    """IACT of one chain's trace: tau(w) = 2 sum_{t <= w} rho(t) - 1 with
    the emcee/Sokal window w = min{i : i >= c tau(i)} (the last lag when
    no lag reaches it); rho by a zero-padded FFT.  A constant trace never
    decorrelates: infinite."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n < 2:
        raise ValueError("a trace of fewer than two steps has no IACT")
    m = 1
    while m < n:
        m <<= 1
    f = np.fft.fft(x - x.mean(), n=2 * m)
    acf = np.fft.ifft(f * np.conjugate(f))[:n].real
    if acf[0] == 0.0:
        return math.inf
    taus = 2.0 * np.cumsum(acf / acf[0]) - 1.0
    reached = np.arange(n) >= c * taus
    w = int(np.argmax(reached)) if reached.any() else n - 1
    return float(taus[w])


def mean_tau(q) -> float:
    """The mean IACT over chains of a (chains, steps) QOI trace."""
    q = np.asarray(q, dtype=np.float64).reshape(-1, np.shape(q)[-1])
    return float(np.mean([iact(row) for row in q]))


def percentile(values, p: float) -> float:
    """The p-th percentile of all ``values``, linear between order
    statistics (position p/100 (n - 1) of the sorted values)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        raise ValueError("no values")
    pos = p / 100.0 * (v.size - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, v.size - 1)
    return float(v[lo] + (pos - lo) * (v[hi] - v[lo]))


def sample_ms(window_s: float, steps: int, chains: int) -> float:
    """Window wall time over the samples it drew, in ms."""
    return 1e3 * window_s / (steps * chains)


def indep_sample_ms(sample: float, tau: float) -> float:
    """Time per independent sample: max(tau, 1) times the time per sample."""
    return max(tau, 1.0) * sample
