"""Explicit, splittable integer keys (the port's ``jax.random`` keys).

A key is a Python int in [0, 2^64).  :func:`split` derives independent
child keys with a splitmix64 finaliser, :func:`randint31` turns a key
into the 31-bit seed/step scalars the kernels hash, and
:func:`generator` seeds a ``torch.Generator`` for the plain draws (the
coarse Cholesky noise and the explicit-noise chains).  Keys live on the
host, so a chain step never waits for the device to derive its noise.
"""

from __future__ import annotations

import torch

__all__ = ["split", "fold_in", "randint31", "generator"]

_M64 = (1 << 64) - 1


def _splitmix64(v: int) -> int:
    v = (v + 0x9E3779B97F4A7C15) & _M64
    v = ((v ^ (v >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    v = ((v ^ (v >> 27)) * 0x94D049BB133111EB) & _M64
    return v ^ (v >> 31)


def split(key: int, n: int = 2) -> tuple:
    """``n`` child keys of ``key`` (the analogue of ``jax.random.split``)."""
    base = _splitmix64(int(key) & _M64)
    return tuple(_splitmix64(base ^ (0xD1B54A32D192ED03 * (i + 1) & _M64))
                 for i in range(n))


def fold_in(key: int, data: int) -> int:
    """A key derived from ``key`` and the integer ``data`` (the analogue
    of ``jax.random.fold_in``)."""
    return _splitmix64((int(key) & _M64) ^ _splitmix64(int(data) & _M64))


def randint31(key: int) -> int:
    """A 31-bit non-negative integer drawn from ``key``."""
    return _splitmix64(int(key) & _M64) >> 33


def generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(_splitmix64(int(key) & _M64) >> 1)
    return g
