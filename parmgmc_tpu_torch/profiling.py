"""Profiling helpers (port of ``parmgmc_tpu.profiling``; the reference's
PETSc log events).

* :func:`trace` -- a ``torch.profiler`` session (CPU and, with a card,
  CUDA activities) exported as a Chrome trace, viewable in Perfetto or
  ``chrome://tracing``,
* :func:`named_scope` -- a named range: ``torch.profiler.record_function``
  and, on the card, an NVTX range,
* :func:`section` -- a wall-clock timer of a host section.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "section", "named_scope"]


@contextlib.contextmanager
def named_scope(name: str):
    """A named range in profiles: ``with profiling.named_scope("cycle"): ...``."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write its Chrome trace to
    ``logdir/trace.json``: ``with profiling.trace("prof"): ...``.  Device
    activity is recorded when a card is present; the block's launches are
    waited for before the session ends."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def section(name: str, results: "dict | None" = None):
    """Wall-clock a host-side section (forces nothing; synchronise first):
    adds the seconds to ``results[name]``, or prints the milliseconds."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = results.get(name, 0.0) + dt
    else:
        print(f"[{name}] {dt * 1000:.2f} ms")
