"""Frozen copy of the program's counter-based N(0, 1) draws.

Each draw is keyed by (seed, step, domain, flat index of the grid point):
a splitmix avalanche of the key, then Box-Muller's cosine branch with
sin/cos as an odd Taylor polynomial after one fold.  The integer
arithmetic runs in int64 reduced mod 2^32; the floating point in the
precision the caller asks for.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
CHAIN_DOMAIN = 0x5851F42D  # level 0 of the V(1,0) chain step
TAIL_DOMAIN = 0xA511E9B3  # + level index, the levels below level 0
SWEEP_DOMAIN = 0x2545F491  # a full red/black sweep
_H2_SALT = 0x63D83595
_TWO_PI = 6.283185307179586
_SIN_COEFFS = tuple(
    (-1.0) ** k * _TWO_PI ** (2 * k + 1) / float(math.factorial(2 * k + 1)) for k in range(6)
)


def _mulmod32(a, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def mix(a, b):
    x = (_mulmod32(a, 0x9E3779B1) + b) & M32
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mulmod32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_prefix(seed: int, step: int, domain: int) -> int:
    return mix(mix(seed & M32, step & M32), domain & M32)


def _sin2pi(x):
    x2 = x * x
    p = torch.full_like(x, _SIN_COEFFS[5])
    for c in _SIN_COEFFS[4::-1]:
        p = p * x2 + c
    return p * x


def _cos2pi(t):
    r = t - torch.floor(t + 0.5)
    return _sin2pi(0.25 - torch.abs(r))


def eta(prefix: int, idx, dtype):
    """One N(0, 1) draw a flat index ``idx`` (int64 tensor)."""
    h1 = mix(prefix, idx)
    h2 = mix(h1, _H2_SALT)
    u1 = (h1 >> 9).to(dtype) * (1.0 / (1 << 23)) + 1e-7
    u2 = (h2 >> 9).to(dtype) * (1.0 / (1 << 23))
    return torch.sqrt(-2.0 * torch.log(u1)) * _cos2pi(u2)
