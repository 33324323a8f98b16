"""Chain drivers (port of ``parmgmc_tpu.chain``).

A chain is a Python loop over the sampler's keyed ``step`` (the port's
stand-in for ``lax.scan``); recorded values stay on the device until the
loop ends, so the loop never waits for the device.  Keys are integers
(:mod:`parmgmc_tpu_torch.keys`).  Many independent chains run one after
another through :func:`multi_chain` (the JAX package vmaps them).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from parmgmc_tpu_torch import keys, replay
from parmgmc_tpu_torch.profiling import span

__all__ = [
    "ChainState",
    "ExplicitNoise",
    "init_chain",
    "sample_chain",
    "sample_chain_deferred",
    "sample_moments",
    "multi_chain",
]


class ChainState(NamedTuple):
    x: torch.Tensor
    key: int


def init_chain(sampler, key: int, x0: Optional[torch.Tensor] = None, batch: tuple = ()) -> ChainState:
    """Fresh chain state (zero start unless ``x0`` is given).  ``batch``
    appends trailing chain dims, the chain-major layout (x of shape
    grid_shape + batch): C independent chains advanced by one keyed step.
    Graph samplers take it (Gibbs, the MGMC stacks over them with a dense
    Cholesky coarse level, LRC over them; see
    :func:`parmgmc_tpu_torch.models.matern.batched_chains_supported`)."""
    if x0 is None:
        shape = tuple(sampler.grid_shape) + tuple(batch)
        x0 = torch.zeros(shape, dtype=sampler.dtype, device=sampler.device)
    return ChainState(x=x0, key=key)


@dataclass(frozen=True)
class ExplicitNoise:
    """A sampler driven through its explicit-noise ``step_with_noise``
    with ``torch.Generator`` draws -- the counterpart of the JAX package's
    plain (``lax``) keyed path, for any configuration."""

    sampler: Any

    def __getattr__(self, name):
        return getattr(self.sampler, name)

    def step(self, key: int, x, b, aux=None):
        from parmgmc_tpu_torch.samplers.gibbs import _draw, with_batch

        key, sub = keys.split(key)
        shapes = with_batch(self.sampler.noise_shapes(), x.shape[len(self.sampler.grid_shape):])
        noises = _draw(sub, shapes, x.dtype, x.device)
        return key, self.sampler.step_with_noise(x, b, noises)


def sample_chain(
    sampler,
    state: ChainState,
    b,
    n_samples: int,
    extract: Optional[Callable[[torch.Tensor], Any]] = None,
    burnin: int = 0,
):
    """(state, stacked extracts of the n_samples recorded samples).

    ``extract`` maps a sample to what is recorded (default: the sample).

    On the card, an MGMC sampler's keyed step is captured in CUDA graphs on
    its first call and replayed from then on wherever its words allow
    (:mod:`parmgmc_tpu_torch.replay`): the same samples, without the host's
    dispatch of every op.  A recorded value that lies in the graphs'
    buffers is copied, and so is the returned state."""
    aux = sampler.prepare(b)
    extract = extract or (lambda x: x)
    graphs = replay.graphs_for(sampler, state.x, b, False)
    step = sampler.step if graphs is None else graphs.stepper(sampler)
    key, x = state.key, state.x
    out = []
    for i in range(burnin + n_samples):
        with span("pmg.chain.step"):
            key, x = step(key, x, b, aux)
            if i >= burnin:
                v = extract(x)
                out.append(v.clone() if graphs is not None and graphs.owns(v) else v)
    if graphs is not None and graphs.owns(x):
        x = x.clone()
    stacked = torch.stack(out) if out else torch.zeros((0,), dtype=x.dtype, device=x.device)
    return ChainState(x=x, key=key), stacked


def sample_chain_deferred(sampler, state: ChainState, b, n_samples: int):
    """(state, qoi_means): mean-QOI chain on the lazy (xpy, z) state.

    The sample sequence is bit-identical to :func:`sample_chain` with the
    same keys; the recorded QOI (each sample's mean) comes from the chain
    kernel's partial sums, one step late for the carry's part: step t+1
    reports the P z part of sample t's sum while it streams z.  The
    returned state is materialised.

    On the card, a sampler's step is captured in CUDA graphs on its first
    call and replayed from then on (:mod:`parmgmc_tpu_torch.replay`): the
    same samples, without the host's dispatch of every op."""
    npts = math.prod(sampler.grid_shape)
    if n_samples == 0:
        return state, torch.zeros((0,), dtype=state.x.dtype, device=state.x.device)
    graphs = replay.graphs_for(sampler, state.x, b)
    step = sampler.step_deferred if graphs is None else graphs.stepper(sampler)
    key, xpy = state.key, state.x
    # the starting state seeds the carry (the probed posterior route
    # carries B^T x beside z, zero only for a zero start)
    z = sampler.deferred_init(state.x.dtype, state.x)
    sx_prev = torch.zeros((), dtype=state.x.dtype, device=state.x.device)
    q = []
    for _ in range(n_samples):
        with span("pmg.chain.step"):
            key, xpy, z, sx, zs_prev = step(key, xpy, z, b)
            q.append((sx_prev + zs_prev) / npts)
            sx_prev = sx
    q.append((sx_prev + sampler.deferred_final_sum(z)) / npts)
    return ChainState(x=sampler.materialize_deferred(xpy, z), key=key), torch.stack(q[1:])


def sample_moments(sampler, state: ChainState, b, n_samples: int, burnin: int = 0):
    """(state, mean, var): running mean and variance (Welford) over the
    n_samples recorded samples, without storing the stream."""
    aux = sampler.prepare(b)
    key, x = state.key, state.x
    mean = torch.zeros_like(x)
    m2 = torch.zeros_like(x)
    for i in range(burnin + n_samples):
        with span("pmg.chain.step"):
            key, x = sampler.step(key, x, b, aux)
            if i >= burnin:
                delta = x - mean
                mean = mean + delta / (i - burnin + 1)
                m2 = m2 + delta * (x - mean)
    var = m2 / max(n_samples - 1, 1)
    return ChainState(x=x, key=key), mean, var


def _take(a, i: int):
    """Chain i of a stacked argument: a ChainState (x of shape (C, ...),
    key a tuple of C ints), a tensor (leading chain axis), or a tuple or
    list of such."""
    if isinstance(a, ChainState):
        return ChainState(x=a.x[i], key=a.key[i])
    if isinstance(a, (tuple, list)):
        return type(a)(_take(v, i) for v in a)
    return a[i]


def _chains_of(a) -> int:
    if isinstance(a, ChainState):
        return len(a.key)
    if isinstance(a, (tuple, list)):
        return _chains_of(a[0])
    return a.shape[0]


def _stack(outs):
    """The per-chain results stacked the way :func:`_take` reads them."""
    first = outs[0]
    if isinstance(first, ChainState):
        return ChainState(x=torch.stack([o.x for o in outs]), key=tuple(o.key for o in outs))
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([o[j] for o in outs]) for j in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    return tuple(outs)  # a key


def multi_chain(fn: Callable, n_chains: int):
    """``fn`` mapped over a leading chain axis of all its arguments (the
    JAX ``vmap``): ChainStates stacked as x of shape (C, ...) and key a
    tuple of C ints, tensors with a leading axis of C; the results come
    back stacked the same way.

    The chains run one after another through the sampler's own keyed
    step, so a kernel sampler (whose kernels take one chain) runs its
    kernels, and chain c gives bit for bit what ``fn`` gives on chain c
    alone.  For C chains advanced by one keyed step on a plain-route
    sampler, see the chain-major layout (``init_chain(..., batch=)``)."""

    def run(*args):
        for a in args:
            if _chains_of(a) != n_chains:
                raise ValueError(f"an argument holds {_chains_of(a)} chains, not {n_chains}")
        return _stack([fn(*(_take(a, i) for a in args)) for i in range(n_chains)])

    return run
