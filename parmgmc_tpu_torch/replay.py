"""A chain's step, captured once in CUDA graphs and replayed.

A keyed MGMC step is a few kernels and some dozen (the V(1,0) prior) to
some thousand (the linear-Galerkin V(2,2)) plain-torch ops, each
dispatched by the host; at 256^3 that dispatch takes longer than the
card's work.  Here the step is captured in a CUDA graph
(``torch.cuda.graphs``) and replayed for every later step, so a step
costs the host one replay.  Two steps are captured so: the deferred
V(1,0) step of :func:`parmgmc_tpu_torch.chain.sample_chain_deferred`
(``step_deferred``), and the keyed step x <- x + M_mg(b - A x) of
:func:`~parmgmc_tpu_torch.chain.sample_chain` (``step``), on either route.

What changes from step to step is the step's noise: the kernels' hash
prefixes and the seeds of the ``torch.Generator`` draws, all derived on
the host from the step's key by the sampler's ``keyed_words``, the same
derivation the eager step reads.  The captured kernels read their
prefixes from one device slot (``prefix_at``), which one copy a step
fills, ordered on the stream before the replay, from a ring of pinned
host slots (an event guards each slot until its copy has run).  Each
draw site has one generator registered with the graphs and seeded anew
before each replay: ``manual_seed`` puts the Philox offset back to 0, so
the draws are a fresh generator's, as in the eager step.

Two graphs swap their static buffers (the state: xpy, the carry z and, on
the probed posterior route, B^T x for the deferred step; x for the plain
one): graph 0 steps the buffers A into the buffers B, graph 1 B into A,
so no field is copied a step.  Each graph has its own memory pool: in a
shared one the second capture may place its outputs (the QOI partial
sums, read after the next step) in the first graph's temporaries, which
that graph's next replay overwrites.  A call copies its start state into
A once, and its end state is materialized into a fresh tensor; nothing a
caller holds is a buffer a later replay overwrites (the caller copies
what it keeps of a returned state, :meth:`StepGraphs.owns`).

The graphs are kept per sampler and kind of step and captured on the
first step of the first call, after that step has run eagerly (it builds
the kernels and every lazy set-up the capture must not meet); another b
tensor, shape, dtype or device captures them anew.  Each replay counts
``chain_step_graph`` and the kernels it holds in
``kernels.launch_counts()``.  The spans inside a step fire while it is
captured, not when it is replayed.  A sampler whose step holds draws
outside this scheme (``Words.defer``: a graph hierarchy, float64 levels,
a plain smoother), or whose capture fails (with a warning), runs the
eager step.
"""

from __future__ import annotations

import gc
import warnings
import weakref

import numpy as np
import torch

from parmgmc_tpu_torch import kernels

__all__ = ["StepGraphs", "graphs_for"]

RING = 4  # pinned host slots of prefixes

# sampler -> {deferred: its StepGraphs} (held while the sampler lives)
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def graphs_for(sampler, x, b, deferred: bool = True):
    """The captured step of ``sampler`` for a chain state like ``x`` and
    the right-hand side ``b`` -- ``step_deferred`` (``deferred``) or
    ``step`` -- or None where the chain runs the eager step: x off the
    card or with chain dims, a sampler without keyed words (or, deferred,
    without the V(1,0) kernel route), or a step that cannot be
    replayed."""
    if x.device.type != "cuda" or not hasattr(sampler, "keyed_words"):
        return None
    if deferred and not sampler.deferred_eligible():
        return None
    if tuple(x.shape) != tuple(sampler.grid_shape):
        return None
    kinds = _GRAPHS.setdefault(sampler, {})
    graphs = kinds.get(deferred)
    if graphs is None or not graphs.fits(x, b):
        graphs = kinds[deferred] = StepGraphs(x, b, deferred)
    return None if graphs.refused else graphs


def _pair_like(z):
    if isinstance(z, tuple):
        return tuple(torch.empty_like(t) for t in z)
    return torch.empty_like(z)


def _copy_into(dst, src):
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        dst.copy_(src)


class StepGraphs:
    """The two graphs of one sampler's deferred (``deferred``) or plain
    keyed step, for one b and one shape, dtype and device of the chain
    state."""

    def __init__(self, x, b, deferred: bool = True):
        self.b = b
        self.deferred = deferred
        self.like = (tuple(x.shape), x.dtype, x.device)
        self.refused = False
        self.graphs = None

    def fits(self, x, b) -> bool:
        return b is self.b and self.like == (tuple(x.shape), x.dtype, x.device)

    def owns(self, t) -> bool:
        """Does ``t`` lie in a state buffer x of the plain step's graphs?"""
        return (self.graphs is not None and isinstance(t, torch.Tensor) and any(
            t.untyped_storage().data_ptr() == buf[0].untyped_storage().data_ptr() for buf in self.bufs))

    def _run(self, sampler, cur, state, b, out=None):
        """(state', outputs): the step from ``state`` on the cursor
        ``cur``, the new state into ``out`` when given: ``state`` is
        (xpy, z) and the outputs (sum_xpy', zprev_sum) for the deferred
        step, (x,) and none for the plain one."""
        if self.deferred:
            xpy, z, sx, zs = sampler.step_deferred_from(cur, *state, b, out=out)
            return (xpy, z), (sx, zs)
        return (sampler.step_from(cur, state[0], b, out=None if out is None else out[0]),), ()

    def stepper(self, sampler):
        """The step of one chain call, with the arguments and results of
        ``step_deferred`` (deferred) or ``step``: the call's first step
        loads its start state into the graphs' buffers, and the state it
        returns is those buffers."""
        fresh = [True]

        def advance(key, state, b):
            words = sampler.keyed_words(key)
            if self.graphs is None:
                cur = words.cursor()
                state, outs = self._run(sampler, cur, state, b)
                cur.close()
                if self.refused or not self._capture(sampler, state, b, words):
                    return words.key, state, outs
                fresh[0] = False
                self._load(state)
                return words.key, self.bufs[0], outs
            if fresh[0]:
                fresh[0] = False
                self._load(state)
            p = self.turn_graph
            self._replay(words, p)
            self.turn_graph = 1 - p
            return words.key, self.bufs[1 - p], self.outs[p]

        if self.deferred:
            def step(key, xpy, z, b):
                key, (xpy, z), outs = advance(key, (xpy, z), b)
                return (key, xpy, z, *outs)
        else:
            def step(key, x, b, aux=None):
                key, (x,), _ = advance(key, (x,), b)
                return key, x
        return step

    def _load(self, state):
        """A call's start state into the buffers A, which graph 0 reads."""
        for buf, v in zip(self.bufs[0], state):
            _copy_into(buf, v)
        self.turn_graph = 0

    def _capture(self, sampler, state, b, words) -> bool:
        """Capture both graphs from ``state`` (shapes only); False, with the
        step left eager, where its words cannot be replayed or the capture
        fails."""
        if not words.replayable:
            self.refused = True
            return False
        before = kernels.launch_counts()
        try:
            self._capture_graphs(sampler, state, b, words)
            return True
        except Exception as err:  # the eager step still serves the chain
            self.refused = True
            self.graphs = None
            first = err.__context__ or err  # the error inside the capture, where there is one
            warnings.warn(f"the chain step could not be captured in a CUDA graph, "
                          f"so it runs eagerly: {first!r}", RuntimeWarning, stacklevel=4)
            return False
        finally:
            # a capture is not a step: its launches do not count
            after = kernels.launch_counts()
            kernels.count_launches({k: before[k] - after[k] for k in after})

    def _capture_graphs(self, sampler, state, b, words):
        dev = state[0].device
        n = len(words.prefixes)
        self.slot = torch.zeros(n, dtype=torch.int32, device=dev)
        ring = [torch.zeros(n, dtype=torch.int32, pin_memory=True) for _ in range(RING)]
        self.ring = [(t, t.numpy().view(np.uint32)) for t in ring]
        self.events = [torch.cuda.Event() for _ in range(RING)]
        self.turn_slot = 0
        self.gens = [torch.Generator(device=dev) for _ in words.seeds]
        self.bufs = [tuple(_pair_like(v) for v in state) for _ in range(2)]
        graphs, outs, counts = [], [], []
        # no garbage collection inside a capture: a graph it destroys there
        # (another sampler's, dead in a reference cycle) invalidates the capture
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            for p in range(2):
                self._capture_one(p, sampler, b, words, graphs, outs, counts)
        finally:
            if collecting:
                gc.enable()
        self.graphs, self.outs, self.counts = graphs, outs, counts

    def _capture_one(self, p, sampler, b, words, graphs, outs, counts):
        """Capture graph p, which steps the buffers p into the buffers
        1 - p; append it, its outputs (the deferred step's QOI partial
        sums) and the launches it holds."""
        graph = torch.cuda.CUDAGraph()
        for gen in self.gens:
            graph.register_generator_state(gen)
        start = kernels.launch_counts()
        cur = words.cursor(prefix_at=self.slot, generators=self.gens)
        with torch.cuda.graph(graph):
            _, step_outs = self._run(sampler, cur, self.bufs[p], b, out=self.bufs[1 - p])
        cur.close()
        end = kernels.launch_counts()
        held = {k: end[k] - start[k] for k in end if end[k] != start[k]}
        held["chain_step_graph"] = 1
        graphs.append(graph)
        outs.append(step_outs)
        counts.append(held)

    def _replay(self, words, p):
        """Graph p on the step ``words``: its prefixes into the device slot
        (one copy, on the stream before the replay), its generators
        seeded, the replay, its launches counted."""
        i = self.turn_slot
        self.turn_slot = (i + 1) % RING
        self.events[i].synchronize()  # slot i's last copy has run
        host, view = self.ring[i]
        view[:] = words.prefixes
        self.slot.copy_(host, non_blocking=True)
        self.events[i].record()
        for gen, seed in zip(self.gens, words.seeds):
            gen.manual_seed(seed)
        self.graphs[p].replay()
        kernels.count_launches(self.counts[p])
