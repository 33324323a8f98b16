"""Frozen copy of the program's integer keys (splitmix64 splits).

A key is a Python int in [0, 2^64).  The program derives every draw of a
chain step from its key by these rules, so the reference can draw the
same numbers without reading anything the program made.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1


def splitmix64(v: int) -> int:
    v = (v + 0x9E3779B97F4A7C15) & _M64
    v = ((v ^ (v >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    v = ((v ^ (v >> 27)) * 0x94D049BB133111EB) & _M64
    return v ^ (v >> 31)


def split(key: int, n: int = 2) -> tuple:
    """``n`` child keys of ``key``."""
    base = splitmix64(int(key) & _M64)
    return tuple(splitmix64(base ^ (0xD1B54A32D192ED03 * (i + 1) & _M64)) for i in range(n))


def randint31(key: int) -> int:
    """The 31-bit integer drawn from ``key`` (a kernel's seed or step)."""
    return splitmix64(int(key) & _M64) >> 33


def generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(splitmix64(int(key) & _M64) >> 1)
    return g


def randn(key: int, shape, device, dtype=torch.float32):
    """The standard normals the program draws from ``key`` in its own
    precision ``dtype``, one generator a key."""
    return torch.randn(shape, generator=generator(key, device), dtype=dtype, device=device)
