"""The port's spans (``parmgmc_tpu_torch.profiling``) on the CPU.

* spans off: ``span`` returns one shared null context and a profiler
  session over a chain step records no ``pmg.`` event;
* spans on: the span tree of a chain step on each route -- the 16^3
  aggregate prior and posterior and the 24^3 prior, whose levels below 0
  the tail refuses, through ``sample_chain_deferred`` (the kernels' CPU
  twins) and a small LRC graph MGMC run chain-major through
  ``sample_chain`` -- has the names and nesting the module documents;
* the samples and QOI are bit for bit the same with spans on and off;
* every span name in the port is ``pmg.<layer>...`` and holds no ``::``.
"""

import ast
import contextlib
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import parmgmc_tpu_torch
from parmgmc_tpu_torch import profiling
from parmgmc_tpu_torch.chain import init_chain, sample_chain, sample_chain_deferred
from parmgmc_tpu_torch.models import mesh
from parmgmc_tpu_torch.models.obs import make_posterior_operator
from parmgmc_tpu_torch.models.problems import gmrf_3d
from parmgmc_tpu_torch.operators.graph import from_csr
from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

# the entry points default to the card; these tests run on the host
DEV = "cpu"
STEPS = 3
CHAINS = 4
# three levels at 16^3 (16, 8, 4): level 1 runs the tail, level 2 is the coarsest
V10 = dict(n_pre=1, n_post=0, coarsest_size=16, coarsening="aggregate")
BALLS = dict(coords=np.array([[0.3, 0.4, 0.5], [0.6, 0.3, 0.2], [0.5, 0.7, 0.8]]),
             radii=np.full(3, 0.2), values=np.array([1.0, -0.5, 0.7]))
OBS2D = dict(sigma2=0.01, coords=[[0.3, 0.3], [0.7, 0.6]], radii=[0.25, 0.2], values=[1.0, -0.5])

C, D0, TAIL, COARSE, UP = ("pmg.chain.step", "pmg.mgmc.down0", "pmg.mgmc.tail", "pmg.mgmc.coarse",
                           "pmg.mgmc.up")
LEVEL = "pmg.mgmc.level"
SMOOTH, RESTRICT, LRC, SWEEP = "pmg.mgmc.smooth", "pmg.mgmc.restrict", "pmg.lrc", "pmg.graph.sor_sweep"
# (depth, name) of one chain step's spans, in start order
TREES = {
    "prior": [(0, C), (1, D0), (1, TAIL), (1, COARSE), (1, UP)],
    # 24^3: levels 12^3 and 6^3 each on a from-zero kernel call of its own
    # (#3), the coarse 3^3 sample, the prolong-adds onto 6^3 and 12^3 (level
    # 0's is the deferred carry)
    "prior-levels": [(0, C), (1, D0), (1, LEVEL), (1, LEVEL), (1, COARSE), (1, UP), (1, UP)],
    # level 0: the rank-k windows around #1; level 1: the general cycle,
    # its LRC smoother's draw, b stream and Woodbury correction around #7
    "posterior": [(0, C), (1, LRC), (2, D0), (1, SMOOTH), (2, LRC), (2, LRC), (2, LRC),
                  (1, RESTRICT), (1, COARSE), (1, UP), (1, SMOOTH)],
    # the fine residual, the V(1,1) cycle over two levels, the chain's update
    "graph": [(0, C), (1, RESTRICT), (1, SMOOTH), (2, LRC), (2, SWEEP), (2, LRC), (1, RESTRICT),
              (1, COARSE), (1, UP), (1, SMOOTH), (2, LRC), (2, SWEEP), (2, LRC), (1, UP)],
}


@pytest.fixture(autouse=True)
def _one_thread_spans_restored():
    torch.set_num_threads(1)
    prev = profiling.enabled()
    try:
        yield
    finally:
        profiling.enable(prev)


def _grid(posterior, n=16):
    op = gmrf_3d(n, 1.0, dtype=torch.float32, device=DEV)
    b = None
    if posterior:
        op, b = make_posterior_operator(op, 0.01, BALLS["coords"], BALLS["radii"],
                                        obsvals=BALLS["values"])
    smp = MGMCSampler.create(op, **V10)
    st = init_chain(smp, 7)
    return lambda: sample_chain_deferred(smp, st, b, STEPS)


def _graph():
    pts, cells = mesh.unit_square_mesh(6)
    op = from_csr(mesh.matern_precision_mesh(pts, cells, 2.0), device=DEV)
    B, si, f = mesh.mesh_observation_mats(pts, cells, OBS2D["sigma2"], OBS2D["coords"],
                                          OBS2D["radii"], OBS2D["values"])
    perm = op.perm.numpy()
    post = LRCOperator(base=op, B=torch.from_numpy(np.array(B[perm])),
                       sigma_inv=torch.from_numpy(np.array(si)))
    smp = MGMCSampler.create(post, n_levels=2, n_pre=1, n_post=1)
    st = init_chain(smp, 11, batch=(CHAINS,))
    b = torch.from_numpy(np.array(f[perm]))
    return lambda: sample_chain(smp, st, b, STEPS, extract=lambda x: x.sum(dim=0))


ROUTES = {"prior": lambda: _grid(False), "prior-levels": lambda: _grid(False, 24),
          "posterior": lambda: _grid(True), "graph": _graph}


def _spans(run):
    """(result, [(depth, name)]): the run's result and every ``pmg.`` event
    a CPU profiler session over it records, in start order, each at its
    nesting depth."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    evs = sorted((e.start_ns(), -(e.start_ns() + e.duration_ns()), e.name())
                 for e in prof.profiler.kineto_results.events() if e.name().startswith("pmg."))
    tree, ends = [], []
    for s, neg_end, name in evs:
        while ends and ends[-1] <= s:
            ends.pop()
        tree.append((len(ends), name))
        ends.append(-neg_end)
    return out, tree


def test_spans_off_are_one_shared_null_context():
    profiling.enable(False)
    a, b = profiling.span("pmg.chain.step"), profiling.span("pmg.mgmc.up")
    assert a is b and isinstance(a, contextlib.nullcontext)
    assert not profiling.enabled()
    assert profiling.enable(True) is False and profiling.enabled()
    assert isinstance(profiling.span("pmg.chain.step"), torch.profiler.record_function)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_no_span_recorded_while_off(route):
    run = ROUTES[route]()
    profiling.enable(False)
    _, tree = _spans(run)
    assert tree == []


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_span_tree_of_a_chain_step(route):
    run = ROUTES[route]()
    profiling.enable(True)
    _, tree = _spans(run)
    assert tree == TREES[route] * STEPS


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_samples_bit_identical_with_spans_on_and_off(route):
    run = ROUTES[route]()
    profiling.enable(False)
    (state_off, q_off) = run()
    profiling.enable(True)
    (state_on, q_on), _ = _spans(run)
    assert state_on.key == state_off.key
    assert torch.equal(state_on.x, state_off.x) and torch.equal(q_on, q_off)


def _span_literals():
    """Every string literal passed to ``span`` in the port's sources."""
    root = os.path.dirname(parmgmc_tpu_torch.__file__)
    names = []
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(d, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", None)) == "span"
                        and node.args and isinstance(node.args[0], ast.Constant)):
                    names.append(node.args[0].value)
    return names


def test_every_span_name_is_pmg_and_no_torch_op():
    names = set(_span_literals())
    assert {name for tree in TREES.values() for _, name in tree} <= names
    for name in names:
        layer = name.split(".")
        assert name.startswith("pmg.") and "::" not in name and len(layer) >= 2 and all(layer), name
