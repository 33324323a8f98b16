"""Profiling (port of ``parmgmc_tpu.profiling``; the reference's PETSc log
events): the port's one span facility.

* :func:`span` -- a named range at a layer boundary of the sampling path,
  ``with profiling.span("pmg.mgmc.up"): ...``.  Off by default: it then
  returns one shared null context and costs one global check.  On, it is
  a ``torch.profiler.record_function``, recorded on the profiler's clock
  in the same timeline as the device activity.
* :func:`enable` / :func:`enabled` -- turn spans on and off, and read the
  state.
* :func:`trace` -- a ``torch.profiler`` session (CPU and, with a card,
  CUDA activities) with spans on, exported as a Chrome trace, viewable in
  Perfetto or ``chrome://tracing``.

Span names are ``pmg.<layer>.<phase>`` and hold no ``::`` (a profiler
reader takes a ``::`` name for a torch op).  The program opens a fixed
number of spans a chain step, at call boundaries only:

``pmg.chain.step``
    a chain driver's step (``chain.py``), QOI and bookkeeping included;
``pmg.mgmc.down0``
    the level-0 chain kernel call (``MGMCSampler._fused_chain_down``);
``pmg.mgmc.tail``
    the tail kernel's call (``MGMCSampler._fused_tail_cycle``);
``pmg.mgmc.level``
    a level's from-zero down-phase kernel call (``MGMCSampler._fused_down``);
``pmg.mgmc.coarse``
    the coarse sampler's steps;
``pmg.mgmc.up``
    the prolong-adds and the chain's own update;
``pmg.mgmc.smooth``, ``pmg.mgmc.restrict``
    the general cycle's smoothing steps, and its residuals and
    restrictions;
``pmg.lrc``
    the rank-k windows and Woodbury corrections of an LRC operator;
``pmg.galerkin.sweep``
    one half-sweep's launches of the 27-point colour-sweep kernel
    (``GibbsSampler`` on a Galerkin level);
``pmg.graph.sor_sweep``
    one direction of a graph operator's colour sweep.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["span", "enable", "enabled", "trace"]

_ON = False
_NULL = contextlib.nullcontext()


def span(name: str):
    """A named range in profiles: one shared null context while spans are
    off, else ``torch.profiler.record_function(name)``."""
    if not _ON:
        return _NULL
    return torch.profiler.record_function(name)


def enable(on: bool = True) -> bool:
    """Turn spans on or off for the process; returns the previous state."""
    global _ON
    prev, _ON = _ON, bool(on)
    return prev


def enabled() -> bool:
    return _ON


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with spans on and write its Chrome trace to
    ``logdir/trace.json``: ``with profiling.trace("prof"): ...``.  Device
    activity is recorded when a card is present; the block's launches are
    waited for before the session ends, and the spans' previous state is
    restored."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prev = enable(True)
    try:
        with profile(activities=acts) as prof:
            try:
                yield
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        enable(prev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
