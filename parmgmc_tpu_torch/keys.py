"""Explicit, splittable integer keys (the port's ``jax.random`` keys).

A key is a Python int in [0, 2^64).  :func:`split` derives independent
child keys with a splitmix64 finaliser, :func:`randint31` turns a key
into the 31-bit seed/step scalars the kernels hash, and
:func:`generator` seeds a ``torch.Generator`` for the plain draws (the
coarse Cholesky noise and the explicit-noise chains).  Keys live on the
host, so a chain step never waits for the device to derive its noise.

:class:`Words` holds the integers one keyed step derives from its key
for the device, in the order the step uses them; the step reads them
through a :class:`Cursor`, so an eager step and a step replayed from a
captured CUDA graph (:mod:`parmgmc_tpu_torch.replay`) take the same
numbers from one derivation.
"""

from __future__ import annotations

import torch

__all__ = [
    "split", "fold_in", "randint31", "draw_pair", "generator", "generator_seed", "seeded",
    "Words", "Cursor",
]

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


def draw_pair(key: int) -> tuple:
    """(key', seed, step): a kernel launch's two 31-bit scalars from
    ``key`` (key', k1, k2 = split(key, 3); randint31 of k1 and of k2)."""
    key, k1, k2 = split(key, 3)
    return key, randint31(k1), randint31(k2)


def generator_seed(key: int) -> int:
    """The seed :func:`generator` gives its ``torch.Generator`` for ``key``."""
    return _splitmix64(int(key) & _M64) >> 1


def seeded(seed: int, device) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed)
    return g


def generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    return seeded(generator_seed(key), device)


class Words:
    """The integers a keyed step hands the device, in the order it uses
    them, and the chain's key after the step (``key``).  Entries:

    * ``("launch", (seed, step, domains))``: a kernel launch whose draws
      hash (seed, step) under each noise domain of ``domains`` (one a level
      of the tail kernel);
    * ``("seed", s)``: a ``torch.Generator`` seeded with ``s``;
    * ``("key", k)``: a sub-step that derives its own draws from the key
      ``k`` on the host (a sampler outside this scheme); no graph replays
      a step that holds one."""

    def __init__(self):
        self.entries = []
        self.key = None

    def launch(self, seed: int, step: int, domains) -> None:
        self.entries.append(("launch", (seed, step, tuple(domains))))

    def seed(self, key: int) -> None:
        """The generator :func:`generator` would seed from ``key``."""
        self.entries.append(("seed", generator_seed(key)))

    def defer(self, key: int) -> None:
        self.entries.append(("key", key))

    @property
    def prefixes(self) -> tuple:
        """Every launch's hash prefixes in launch order, a domain at a time."""
        from parmgmc_tpu_torch.kernels._noise import hash_prefix

        return tuple(hash_prefix(seed, step, d) for kind, v in self.entries if kind == "launch"
                     for seed, step, domains in (v,) for d in domains)

    @property
    def seeds(self) -> tuple:
        return tuple(v for kind, v in self.entries if kind == "seed")

    @property
    def replayable(self) -> bool:
        return all(kind != "key" for kind, _ in self.entries)

    def cursor(self, prefix_at=None, generators=None) -> "Cursor":
        return Cursor(self, prefix_at, generators)


class Cursor:
    """Reads a step's :class:`Words` in order.  Eager (no arguments): each
    launch takes its prefix by value and each draw a fresh generator.  In a
    capture: launch i reads its prefixes from its words of ``prefix_at``
    (an int32 device tensor holding :attr:`Words.prefixes`) and draw j
    takes ``generators[j]``, both set anew before every replay."""

    def __init__(self, words: Words, prefix_at=None, generators=None):
        self._entries = words.entries
        self._i = self._word = self._gen = 0
        self._at = prefix_at
        self._gens = generators

    def _next(self, kind):
        if self._i >= len(self._entries):
            raise RuntimeError(f"the step asked for a {kind} past the end of its words")
        got, value = self._entries[self._i]
        if got != kind:
            raise RuntimeError(f"the step asked for a {kind} where its words hold a {got}")
        self._i += 1
        return value

    def launch(self) -> tuple:
        """(seed, step, prefix_at): the next launch's scalars and where its
        prefixes lie in device memory (None: by value)."""
        seed, step, domains = self._next("launch")
        at = None
        if self._at is not None:
            at = self._at[self._word:self._word + len(domains)]
        self._word += len(domains)
        return seed, step, at

    def generator(self, device) -> torch.Generator:
        seed = self._next("seed")
        if self._gens is None:
            return seeded(seed, device)
        self._gen += 1
        return self._gens[self._gen - 1]

    def key(self) -> int:
        return self._next("key")

    def close(self) -> None:
        """Raise unless the step read every word."""
        if self._i != len(self._entries):
            raise RuntimeError(f"the step read {self._i} of its {len(self._entries)} words")
