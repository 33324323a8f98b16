"""Counter-based noise shared by the kernels and their plain twins.

Port of the JAX package's portable noise helpers: ``_mix`` (splitmix
avalanche, ``parmgmc_tpu/kernels/rb_gibbs.py:87-95``), ``_sin2pi_poly``
and ``_sincos2pi`` (``rb_gibbs.py:98-130``) and ``_eta_hash``
(``parmgmc_tpu/kernels/mg_tail.py:74-87``).  The CUDA side of every
function is in ``csrc/noise.cuh``; the two are kept line for line alike.

Each N(0, 1) draw is keyed by (seed, step, domain, flat index of the
true DOF): a halo cell recomputed by a neighbouring tile regenerates the
same draw, and the kernel and its twin draw the same numbers.  The tail
levels use the domain ``0xA511E9B3 + li`` of ``_eta_hash`` (so the twin
matches the JAX tail reference with the noise on); the level-0 chain
kernel uses :data:`CHAIN_DOMAIN`, the full red/black sweep kernels
:data:`SWEEP_DOMAIN`, the colour sweep of the 27-point Galerkin levels
(``kernels.galerkin_sweep``) :data:`GALERKIN_DOMAIN`, and the patch sweep
kernels (``kernels.patch_sweep``) :data:`PATCH_DOMAIN` + j for member j of
the patch centred at the index.

torch has no ``>>`` for ``uint32`` on the CPU, so the integer arithmetic
runs in ``int64`` with every product and sum reduced mod 2^32.  A 32x32
bit product does not fit a signed 64-bit integer, so products are taken
in 16-bit halves.  The same functions accept Python ints (the per-call
hash prefix is computed on the host once).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "CHAIN_DOMAIN",
    "TAIL_DOMAIN",
    "SWEEP_DOMAIN",
    "GALERKIN_DOMAIN",
    "PATCH_DOMAIN",
    "mix",
    "hash_prefix",
    "sin2pi_poly",
    "sincos2pi",
    "eta_hash",
]

_M32 = 0xFFFFFFFF
# level 0's key domain; the tail uses TAIL_DOMAIN + level (as _eta_hash)
CHAIN_DOMAIN = 0x5851F42D
TAIL_DOMAIN = 0xA511E9B3
# the full sweeps (kernels.rb_gibbs); keyed by (seed, half-sweep step)
SWEEP_DOMAIN = 0x2545F491
# the 8-colour sweeps of 27-point stencils (kernels.galerkin_sweep); keyed
# like SWEEP_DOMAIN
GALERKIN_DOMAIN = 0x3C6EF372
# the patch sweeps; member j of a vertex-star patch draws under PATCH_DOMAIN + j
PATCH_DOMAIN = 0x7F4A7C15
_H2_SALT = 0x63D83595

_TWO_PI = 6.283185307179586
# sin(2 pi x) on [-1/4, 1/4] as an odd Taylor polynomial in x (degree 11)
SINCOS_COEFFS = tuple(
    (-1.0) ** k * _TWO_PI ** (2 * k + 1) / float(math.factorial(2 * k + 1))
    for k in range(6)
)


def _mulmod32(a, c: int):
    """(a * c) mod 2^32 for 0 <= a, c < 2^32 without int64 overflow."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def mix(a, b):
    """splitmix-style avalanche of two uint32s -> uint32 (``_mix``)."""
    x = (_mulmod32(a, 0x9E3779B1) + b) & _M32
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mulmod32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_prefix(seed: int, step: int, domain: int) -> int:
    """mix(mix(seed, step), domain): the per-call part of every draw's key."""
    return mix(mix(seed & _M32, step & _M32), domain & _M32)


def sin2pi_poly(x):
    x2 = x * x
    p = torch.full_like(x, SINCOS_COEFFS[5])
    for c in SINCOS_COEFFS[4::-1]:
        p = p * x2 + c
    return p * x


def sincos2pi(t):
    """(cos 2 pi t, sin 2 pi t) for t in [0, 1): one fold + the polynomial."""
    r = t - torch.floor(t + 0.5)
    a = torch.abs(r)
    sa = torch.where(a > 0.25, 0.5 - a, a)
    ps = sin2pi_poly(sa)
    s = torch.where(r < 0, -ps, ps)
    c = sin2pi_poly(0.25 - a)
    return c, s


def hash_bits(prefix: int, idx):
    """(h1, h2): the two uint32 words (int64 tensors) behind each draw."""
    h1 = mix(prefix, idx)
    return h1, mix(h1, _H2_SALT)


def eta_hash(prefix: int, idx, dtype=torch.float32):
    """One N(0, 1) draw per flat index ``idx`` (int64 tensor): splitmix
    hash + Box-Muller, cos branch (``_eta_hash``)."""
    h1, h2 = hash_bits(prefix, idx)
    u1 = (h1 >> 9).to(dtype) * (1.0 / (1 << 23)) + 1e-7
    u2 = (h2 >> 9).to(dtype) * (1.0 / (1 << 23))
    r = torch.sqrt(-2.0 * torch.log(u1))
    c, _ = sincos2pi(u2)
    return r * c
