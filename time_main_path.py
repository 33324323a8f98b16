#!/usr/bin/env python3
"""Time the port's MGMC drives and large-plane kernels in several checkouts, alternating.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 time_main_path.py --trees OLD NEW --pairs 4 \\
        [--drive 256-v10 256-post 256-v22 256-v22-linear 768-v10 768-v22 patch-256 patch-128 kernels
                 wrench-post wrench-post-256 wrench4-prior matern-256 ex7-256 sharded-256 graph-sharded]
        [--out FILE]

Each run is its own process, so every checkout imports its own
``parmgmc_tpu_torch`` (and builds its kernels under its own ``build/``);
one run times every drive asked for, in the order given.  The runs go OLD
NEW NEW OLD, OLD NEW NEW OLD, ... so that a drift of the host over the
call falls on both alike.  The drives (b = None, the aggregate hierarchy
with ``coarsening="aggregate"``, coarsest 128 DOF requested, but on the
linear drive; b = None but on the posterior drive):

* ``256-v10``: ``chip_smoke.py`` phase 6's main path, gmrf_3d(256), MGMC
  V(1,0) through ``sample_chain_deferred``; 64 warm-up steps, then
  ``--repeats`` windows of 512 steps;
* ``768-v10``: the same chain on gmrf_3d(768) (phase 15); 8 warm-up
  steps, windows of 32;
* ``256-post``: ``chip_smoke.py`` phase 20's posterior path: bench.py
  --posterior's problem (gmrf_3d(256) with five ball observations, b = f),
  MGMC V(1,0) through ``sample_chain_deferred``; 64 warm-up steps, then
  ``--repeats`` windows of 512 steps;
* ``256-v22``: MGMC V(2,2) on gmrf_3d(256) through ``sample_chain`` with
  the mean as QOI (phase 8); 8 warm-up steps, windows of 64;
* ``256-v22-linear``: ``chip_smoke.py`` phase 22's chain, the JAX
  package's default: ``MGMCSampler.create(gmrf_3d(256), n_pre=2,
  n_post=2)`` (``coarsening="linear"``, levels 128^3 ... 16^3 27-point
  stencils swept in plain torch) through ``sample_chain`` with the mean as
  QOI; 4 warm-up steps, windows of 16, then the device time of a step by
  kernel name (``torch.profiler`` over 4 steps) and the idle share;
* ``768-v22``: the same on gmrf_3d(768) (phase 18); 2 warm-up steps,
  windows of 8;
* ``patch-256``, ``patch-128``: the patch-Gibbs chain on the squared prior
  squared_shifted_laplace_fd(n^3, kappa=1) through ``sample_chain`` with
  the mean as QOI (phase 12: #11 at 256^3, #10 at 128^3); 2 warm-up
  sweeps, windows of 16 (256^3) or 32 (128^3); ms/sweep;
* ``wrench-post``: ``chip_smoke.py`` phase 25's unstructured-mesh
  posterior, examples/benchmark/wrench.json (wrench refine 3, 38,132 DOFs,
  kappa 5, three ball observations, sigma^2 = 1e-6, float64) through
  ``MaternMeshSampler.sample`` with the rect-region mean as QOI, one chain,
  MGMC V(1,1) on the algebraic hierarchy; 8 warm-up steps, windows of 128;
  ms/cycle;
* ``wrench-post-256``: the same with 256 chains chain-major
  (``sample_chains``); 8 warm-up steps, windows of 32; ms a step and
  aggregate samples/s;
* ``wrench4-prior``: wrench refine 4 (277,544 DOFs, five levels), the
  prior, one chain, mean QOI; 4 warm-up steps, windows of 32; ms/cycle;
* ``matern-256``: ``chip_smoke.py`` phase 26's structured Matérn façade,
  ``MaternSampler((256,) * 3, kappa=1.0, dtype=float32)`` on the aggregate
  V(1,0) hierarchy (one #1 and one #2 launch a step), ``sample`` with the
  mean as QOI (b = zeros); 16 warm-up steps, then windows of 512 steps;
  ms a step, the device busy time a step (windows of 32 steps queued
  behind a sleeping kernel) and the idle share;
* ``ex7-256``: phase 27's ex7 flow on the same sampler,
  ``sample_until_converged`` with 8 chains, b = 1, the mean as QOI,
  ``check_every=50``, ``method="rank"``, overdispersion 1e3, ``seed`` the
  window's index: the wall seconds of the whole flow and the steps a chain
  it took to converge, a window each;
* ``sharded-256``: ``chip_smoke.py`` phase 29's sharded path,
  ``parallel.fused.make_sharded_mgmc_step`` on gmrf_3d(256)'s aggregate
  V(1,0) sampler (b = None) on S = 1, 2 and 4 slots (distinct cards where
  the machine has S, else S slots on cuda:0), beside the unsharded
  ``MGMCSampler.step`` (``sample_chain``, #1 and #2): 8 warm-up steps, then
  windows of 64 steps; ms a step, the device busy time of one step queued
  behind a sleeping kernel, the idle share, and ms a step over the
  unsharded step's (the machinery overhead of
  ``examples/probe_sharded_overhead.py``);
* ``graph-sharded``: ``chip_smoke.py`` phase 30's timed drive,
  ``parallel.graph_sharded.make_sharded_graph_mgmc_step`` on the wrench
  refine-3 posterior (float64, MGMC V(1,1) on the algebraic hierarchy,
  b = the posterior's right-hand side) with 256 chains chain-major on S =
  1, 2 and 4 slots, beside the unsharded keyed step on the same chains:
  8 warm-up steps, then windows of 32 steps; ms a step, the device busy
  time a step (``torch.profiler`` over 2 steps: a step has more launches
  than the launch queue holds, so a window queued behind a sleeping
  kernel would time the host), the idle share, and ms a step over the
  unsharded step's;
* ``kernels``: device ms per call of the 256^3 main path's two kernels,
  queued behind a sleeping kernel (``device_ms``): #1 at 256^3 (b = None,
  z, both sums, noise; also at 128^3 and (16, 24, 96)) and #2 over the
  256^3 hierarchy's four tail levels, the whole call and each level
  alone (a one-level call), with the host microseconds a #2 call takes
  to return; then device ms per call (CUDA events over 10 calls after
  one warm-up) at 768^3 of #9 (b, noise), #8 (FD with b, and streamed D with
  b = None), #5 and #4 (the main path's call: b = None, z, sums, noise)
  and #3 summed over the six levels below 0 (b, noise), each with the
  coefficients of the 768^3 hierarchy; #7 (b, noise) at every smoothed
  level of the 256^3 and 768^3 V(2,2) hierarchies (the 768^3 one below
  level 0) with that level's coefficients, and summed over a step's
  launches (4 a level), and at (16, 24, 96), and #6 (b = None, noise, the FD diagonal times a
  field in [1.25, 1.75]) at 256^3, each over 20 calls queued behind a
  sleeping kernel (``device_ms``: CUDA events around a run of the small
  levels' kernels otherwise time the host's launch gaps), and the host
  microseconds a #7 call takes to return at 16^3; #11 at 256^3
  and #10 at 128^3 (b = None, noise), CUDA events;
* ``chain-plans``: #1 (b = None, z, both sums, noise) at 256^3, 128^3 and
  (16, 24, 96) with each even segment length of ``CHAIN_SEGS``
  (``device_ms``), beside the plan the rule picks: the measurements
  behind ``_march.wave_plan``;
* ``sweep-plans``: #7 (b, noise) at every level shape of both V(2,2)
  hierarchies and at (16, 24, 96) with each segment length of
  ``PLAN_SEGS`` and the one ``kernels/_march.py``'s rule picks
  (``device_ms``): the measurements behind the rule;
* ``patch-kernels``: #11 at 256^3 and 128^3 and #10 at 128^3, noise on
  and off, b given and None, CUDA events.

A window is timed on the host clock and ended by
``torch.cuda.synchronize()``.  ``256-v10`` and ``256-post`` also report
the device time of a step (windows of 32 steps, or of one
``step_deferred`` on the posterior, queued behind a sleeping kernel,
``device_ms``) and the card's idle share of the step.  The last line is a JSON object with every
run's numbers and, per checkout and metric, the median and the range.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

DRIVES = ("256-v10", "256-post", "256-v22", "256-v22-linear", "768-v10", "768-v22", "patch-256", "patch-128",
          "wrench-post", "wrench-post-256", "wrench4-prior", "matern-256", "ex7-256", "kernels",
          "chain-plans", "sweep-plans", "patch-kernels", "sharded-256", "graph-sharded")
DEV = "cuda"
N_MAIN = 256
N_BIG = 768
# (grid, n_pre, n_post, warm-up steps, steps a window)
CHAINS = {"256-v10": (256, 1, 0, 64, 512), "256-post": (256, 1, 0, 64, 512),
          "256-v22": (256, 2, 2, 8, 64), "256-v22-linear": (256, 2, 2, 4, 16),
          "768-v10": (768, 1, 0, 8, 32), "768-v22": (768, 2, 2, 2, 8)}
# patch chains: (grid, warm-up sweeps, sweeps a window)
PATCH_CHAINS = {"patch-256": (256, 2, 16), "patch-128": (128, 2, 32)}
# unstructured-mesh chains: (refinements, posterior, chains, warm-up steps, steps a window)
MESH_CHAINS = {"wrench-post": (3, True, 1, 8, 128), "wrench-post-256": (3, True, 256, 8, 32),
               "wrench4-prior": (4, False, 1, 4, 32)}
WRENCH_PRESET = "examples/benchmark/wrench.json"
# the structured Matérn drives: warm-up steps, steps a window (matern-256)
MATERN = (16, 512)
# the sharded drives: slot counts, warm-up steps, steps a window
SHARDED = ((1, 2, 4), 8, 64)
GRAPH_SHARDED = ((1, 2, 4), 8, 32, 256)  # and the chains
AGGREGATE_V10 = dict(n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate")


def posterior_problem(n):
    """bench.py --posterior's problem on gmrf_3d(n): (LRC operator, f),
    five balls of radius 0.12, sigma^2 = 0.01, from default_rng(0)."""
    import numpy as np

    from parmgmc_tpu_torch.models.obs import make_posterior_operator
    from parmgmc_tpu_torch.models.problems import gmrf_3d

    rng = np.random.default_rng(0)
    coords = 0.15 + 0.7 * rng.random((5, 3))
    return make_posterior_operator(gmrf_3d(n, kappa=1.0, device=DEV), 0.01, coords, np.full(5, 0.12),
                                   rng.standard_normal(5))


def time_chain(torch, drive, repeats):
    """{metric: [numbers]}: ms/cycle of ``repeats`` windows of one MGMC
    drive (256-v10, 256-post, 256-v22-linear: and its device busy time a
    step and idle share; 256-v22-linear: and its device time a step by
    kernel)."""
    from parmgmc_tpu_torch.chain import init_chain, sample_chain, sample_chain_deferred
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    n, n_pre, n_post, warm, steps = CHAINS[drive]
    if drive == "256-post":
        op, b = posterior_problem(n)
    else:
        op, b = gmrf_3d(n, kappa=1.0, device=DEV), None
    if drive == "256-v22-linear":  # every other argument at its default
        smp = MGMCSampler.create(op, n_pre=n_pre, n_post=n_post)
    else:
        smp = MGMCSampler.create(op, n_pre=n_pre, n_post=n_post, coarsest_size=128,
                                 coarsening="aggregate")
    if n_post == 0:
        run = lambda st, k: sample_chain_deferred(smp, st, b, k)[0]
    else:
        run = lambda st, k: sample_chain(smp, st, b, k, extract=torch.mean)[0]
    st = run(init_chain(smp, 0), warm)
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        st = run(st, steps)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps * 1e3)
    if not bool(torch.isfinite(st.x).all()):
        raise RuntimeError(f"{drive}: the chain state is not finite")
    if drive == "256-v22-linear":
        per = kernel_ms(torch, lambda: run(st, 4), 4)
        busy = sum(per.values())
        res = {f"{drive} ms/cycle": out, f"{drive} device busy ms/step": [busy],
               f"{drive} idle share": [max(0.0, 1.0 - busy / statistics.median(out))]}
        for name, t in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
            res[f"{drive} device ms/step {name}"] = [t]
        return res
    if drive not in ("256-v10", "256-post"):
        return {f"{drive} ms/cycle": out}
    # the device time of a step: windows of 32 steps queued behind a
    # sleeping kernel run back to back, without the host's gaps (the
    # profiler drops records of cooperative launches, as #2's)
    holder, n_win = [st], 32

    def window():
        holder[0] = run(holder[0], n_win)

    if drive == "256-post":
        # a posterior step launches ~200 kernels: a window of one step, or
        # the launch queue fills behind the sleeping kernel and waits on
        # the host
        carry = [st.x, smp.deferred_init(st.x.dtype, st.x)]
        n_win = 1

        def window():
            _, carry[0], carry[1], _, _ = smp.step_deferred(1, carry[0], carry[1], b)

    busy = device_ms(torch, window, 2) / n_win
    return {f"{drive} ms/cycle": out, f"{drive} device busy ms/step": [busy],
            f"{drive} idle share": [max(0.0, 1.0 - busy / statistics.median(out))]}


def time_patch_chain(torch, drive, repeats):
    """ms/sweep of ``repeats`` windows of one patch-Gibbs chain."""
    from parmgmc_tpu_torch.chain import init_chain, sample_chain
    from parmgmc_tpu_torch.models.problems import squared_shifted_laplace_fd
    from parmgmc_tpu_torch.samplers.patch_gibbs import PatchGibbsSampler

    n, warm, steps = PATCH_CHAINS[drive]
    smp = PatchGibbsSampler.create(squared_shifted_laplace_fd((n,) * 3, 1.0, device=DEV))
    run = lambda st, k: sample_chain(smp, st, None, k, extract=torch.mean)[0]
    st = run(init_chain(smp, 0), warm)
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        st = run(st, steps)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps * 1e3)
    if not bool(torch.isfinite(st.x).all()):
        raise RuntimeError(f"{drive}: the chain state is not finite")
    return out


def time_mesh_chain(torch, root, drive, repeats):
    """{metric: [numbers]}: ms a step of ``repeats`` windows of one
    unstructured-mesh drive through MaternMeshSampler (and aggregate
    samples/s with many chains)."""
    from parmgmc_tpu_torch.models.matern import MaternMeshSampler, observations_of, region_qoi

    refine, posterior, chains, warm, steps = MESH_CHAINS[drive]
    with open(os.path.join(root, WRENCH_PRESET)) as f:
        preset = json.load(f)
    ms = MaternMeshSampler(mesh_file="wrench", refinements=refine, kappa=float(preset["kappa"]),
                           observations=observations_of(preset) if posterior else None, coarsest_size=128)
    w = torch.as_tensor(region_qoi(ms.points, preset), device=ms.b.device)
    ms.set_qoi(lambda x: x @ w)
    run = (lambda k: ms.sample(k)) if chains == 1 else (lambda k: ms.sample_chains(k, chains))
    run(warm)
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        q = run(steps)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps * 1e3)
    if not bool(torch.isfinite(q).all()):
        raise RuntimeError(f"{drive}: the QOI trace is not finite")
    if chains == 1:
        return {f"{drive} ms/cycle": out}
    return {f"{drive} ms/step": out, f"{drive} samples/s": [chains / t * 1e3 for t in out]}


def time_matern(torch, drive, repeats):
    """{metric: [numbers]}: the structured Matérn façade at 256^3
    (matern-256: ms a step, device busy ms a step, idle share; ex7-256: the
    ex7 flow's wall seconds and steps a chain)."""
    from parmgmc_tpu_torch.diagnostics.stats import sample_until_converged
    from parmgmc_tpu_torch.models.matern import MaternSampler

    ms = MaternSampler((N_MAIN,) * 3, kappa=1.0, dtype=torch.float32, **AGGREGATE_V10)
    ms.set_qoi(torch.mean)
    warm, steps = MATERN
    ms.sample(warm)
    torch.cuda.synchronize()
    if drive == "ex7-256":
        ones = torch.ones(ms.grid_shape, dtype=torch.float32, device=ms.op.device)
        secs, nsteps = [], []
        for r in range(repeats):
            t0 = time.perf_counter()
            trace, n, rhat = sample_until_converged(ms.sampler, ones, torch.mean, n_chains=8, check_every=50,
                                                    method="rank", overdispersion=1e3, seed=r, max_steps=2000)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            nsteps.append(float(n))
            if not (rhat < 1.05 and bool(torch.isfinite(torch.as_tensor(trace)).all())):
                raise RuntimeError(f"{drive}: no convergence (rhat {rhat} after {n} steps)")
        return {f"{drive} s": secs, f"{drive} steps": nsteps}
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        q = ms.sample(steps)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps * 1e3)
    if not bool(torch.isfinite(q).all()):
        raise RuntimeError(f"{drive}: the QOI trace is not finite")
    n_win = 32
    busy = device_ms(torch, lambda: ms.sample(n_win), 2) / n_win
    return {f"{drive} ms/step": out, f"{drive} device busy ms/step": [busy],
            f"{drive} idle share": [max(0.0, 1.0 - busy / statistics.median(out))]}


def time_sharded(torch, repeats):
    """{metric: [numbers]}: the sharded 256^3 V(1,0) step on 1, 2 and 4
    slots beside the unsharded keyed step (ms a step, device busy ms a
    step, idle share, ratio to the unsharded step)."""
    from parmgmc_tpu_torch.chain import init_chain, sample_chain
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.parallel.fused import make_sharded_mgmc_step
    from parmgmc_tpu_torch.parallel.mesh import make_mesh, shard_array
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    counts, warm, steps = SHARDED
    smp = MGMCSampler.create(gmrf_3d(N_MAIN, kappa=1.0, device=DEV), **AGGREGATE_V10)

    def windows(run):
        run(warm)
        torch.cuda.synchronize()
        out = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(steps)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) / steps * 1e3)
        return out

    st = [init_chain(smp, 0)]

    def plain(k):
        st[0], _ = sample_chain(smp, st[0], None, k)

    res = {"sharded-256 unsharded ms/step": windows(plain)}
    busy = device_ms(torch, lambda: smp.step(1, st[0].x, None), 2)
    res["sharded-256 unsharded device busy ms/step"] = [busy]
    base = statistics.median(res["sharded-256 unsharded ms/step"])
    for n in counts:
        devices = [f"cuda:{i}" for i in range(n)] if torch.cuda.device_count() >= n else ["cuda:0"] * n
        mesh = make_mesh((n,), devices=devices)
        step = make_sharded_mgmc_step(smp, mesh)
        xs = [shard_array(st[0].x, mesh)]

        def run(k):
            key = 1
            for _ in range(k):
                key, xs[0] = step(key, xs[0], None)

        out = windows(run)
        if not all(bool(torch.isfinite(x).all()) for x in xs[0]):
            raise RuntimeError(f"sharded-256: the {n}-slot state is not finite")
        busy = device_ms(torch, lambda: step(1, xs[0], None), 2)
        med = statistics.median(out)
        res[f"sharded-256 S={n} ms/step"] = out
        res[f"sharded-256 S={n} device busy ms/step"] = [busy]
        res[f"sharded-256 S={n} idle share"] = [max(0.0, 1.0 - busy / med)]
        res[f"sharded-256 S={n} / unsharded"] = [t / base for t in out]
    return res


def slot_list(torch, n):
    """n slots: distinct cards where the machine has n, else n on cuda:0."""
    return [f"cuda:{i}" for i in range(n)] if torch.cuda.device_count() >= n else ["cuda:0"] * n


def time_graph_sharded(torch, root, repeats):
    """{metric: [numbers]}: the row-partitioned wrench refine-3 posterior
    step with 256 chains on 1, 2 and 4 slots beside the unsharded keyed
    step (ms a step, device busy ms a step, idle share, ratio)."""
    from parmgmc_tpu_torch.models.matern import MaternMeshSampler, observations_of
    from parmgmc_tpu_torch.parallel.graph_sharded import make_sharded_graph_mgmc_step
    from parmgmc_tpu_torch.parallel.mesh import make_mesh

    counts, warm, steps, C = GRAPH_SHARDED
    with open(os.path.join(root, WRENCH_PRESET)) as f:
        preset = json.load(f)
    ms = MaternMeshSampler(mesh_file="wrench", refinements=3, kappa=float(preset["kappa"]),
                           observations=observations_of(preset), coarsest_size=128)
    smp, b = ms.sampler, ms.b
    x0 = torch.zeros((ms.n, C), dtype=ms.op.dtype, device=b.device)

    def windows(run):
        run(warm)
        torch.cuda.synchronize()
        out = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(steps)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) / steps * 1e3)
        return out

    hold = [x0]

    def plain(k):
        key = 1
        for _ in range(k):
            key, hold[0] = smp.step(key, hold[0], b)

    res = {"graph-sharded unsharded ms/step": windows(plain)}
    base = statistics.median(res["graph-sharded unsharded ms/step"])
    busy = sum(kernel_ms(torch, lambda: plain(2), 2).values())
    res["graph-sharded unsharded device busy ms/step"] = [busy]
    res["graph-sharded unsharded idle share"] = [max(0.0, 1.0 - busy / base)]
    for n in counts:
        mesh = make_mesh((n,), devices=slot_list(torch, n))
        step, spec, lay = make_sharded_graph_mgmc_step(smp, mesh, coords=ms.points, n_chains=C)
        carry = [lay.shard(x0), lay.shard(b)]

        def run(k):
            key = 1
            for _ in range(k):
                key, carry[0] = step(key, carry[0], carry[1])

        out = windows(run)
        if not all(bool(torch.isfinite(x).all()) for x in carry[0]):
            raise RuntimeError(f"graph-sharded: the {n}-slot state is not finite")
        busy = sum(kernel_ms(torch, lambda: run(2), 2).values())
        med = statistics.median(out)
        res[f"graph-sharded S={n} ms/step"] = out
        res[f"graph-sharded S={n} device busy ms/step"] = [busy]
        res[f"graph-sharded S={n} idle share"] = [max(0.0, 1.0 - busy / med)]
        res[f"graph-sharded S={n} / unsharded"] = [t / base for t in out]
    return res


def device_ms(torch, fn, n=20):
    """Device ms per call of fn over n calls after one warm-up, the calls
    queued behind a sleeping kernel so that they run back to back: CUDA
    events around a run of small kernels otherwise time the host's launch
    gaps (and the profiler drops records over many sessions)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0  # an upper bound on the enqueue time
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host * 2e9))  # cycles: twice the enqueue at 2 GHz
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(torch, fn, steps):
    """{kernel name: device ms per step} of one profiled call of fn, which
    runs ``steps`` chain steps, after one warm-up call
    (``torch.profiler``'s summed device time by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {}
    for a in prof.key_averages():
        if a.device_type == torch.autograd.DeviceType.CUDA and a.self_device_time_total > 0:
            name = a.key.replace("(anonymous namespace)::", "")[:72]
            per[name] = per.get(name, 0.0) + a.self_device_time_total / 1e3 / steps
    if not per:
        raise RuntimeError("the profiler saw no device time")
    return per


def host_us(torch, fn, n=200):
    """Host microseconds a call of fn takes to return, over n calls after
    one warm-up, not waiting for the card (whose work per call is shorter)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def event_ms(torch, fn, n=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main_path_kernels(torch):
    """[(name, shape, fn)]: the 256^3 main path's calls of #1 (b = None, z, both
    sums, noise; also at 128^3 and (16, 24, 96)) and #2 (its four tail
    levels, and each alone), with the hierarchy's coefficients."""
    from parmgmc_tpu_torch.kernels import mg_sweep as ms
    from parmgmc_tpu_torch.kernels import mg_tail
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    n = N_MAIN
    smp = MGMCSampler.create(gmrf_3d(n, kappa=1.0, device=DEV), n_pre=1, n_post=0,
                             coarsest_size=128, coarsening="aggregate")
    gen = torch.Generator(device=DEV).manual_seed(2027)
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    s0 = smp.smoothers[0]
    calls = []
    h = 15.0**2  # chip_smoke.py phase 3's ragged shape
    for shape, args in (((n,) * 3, (s0._coeff6(), *s0.fd_params, s0.omega, 1234, 77)),
                        ((n // 2,) * 3, (s0._coeff6(), *s0.fd_params, s0.omega, 1234, 77)),
                        ((16, 24, 96), ([-h] * 6, 1.0, h, 1.0, 1234, 77))):
        x, z = randn(*shape), randn(*(n // 2 for n in shape))
        kw = dict(z=z, with_xsum=True, with_zsum=True)
        calls.append((f"#1 {shape}", shape,
                      lambda x=x, a=args, kw=kw: ms.fused_chain_down_fd(x, None, *a, **kw)))
    shapes = tuple(tuple(o.grid_shape) for o in smp.ops[1:])
    params = [v for s in smp.smoothers[1:] for v in (s.omega, *s.fd_params)]
    bl = randn(*shapes[0])
    calls.append((f"#2 {len(shapes) - 1} levels", shapes,
                  lambda: mg_tail.fused_tail_down(bl, params, 99, 5, 0, shapes)))
    rhs = bl
    for li in range(len(shapes) - 1):
        one, prm = shapes[li:li + 2], params[3 * li:3 * li + 3]
        calls.append((f"#2 level {shapes[li][0]}^3 alone", one,
                      lambda b=rhs, one=one, prm=prm: mg_tail.fused_tail_down(b, prm, 99, 5, 0, one)))
        rhs = randn(*shapes[li + 1])
    return calls, (bl, params, shapes)


def time_kernels(torch):
    """Device ms per call of the 256^3 main path's kernels (#1, #2) and of
    the large-plane kernels at 768^3."""
    from parmgmc_tpu_torch.kernels import _twin
    from parmgmc_tpu_torch.kernels import mg_sweep as ms
    from parmgmc_tpu_torch.kernels import rb_gibbs as rg
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    from parmgmc_tpu_torch.kernels import mg_tail

    out = {}
    calls, (bl, params, shapes) = main_path_kernels(torch)
    for name, _, fn in calls:
        out[name] = device_ms(torch, fn)
    out["#2 host us/call"] = host_us(torch, lambda: mg_tail.fused_tail_down(bl, params, 99, 5, 0, shapes))
    del calls, bl
    n = N_BIG
    smp = MGMCSampler.create(gmrf_3d(n, kappa=1.0, device=DEV), n_pre=1, n_post=0,
                             coarsest_size=128, coarsening="aggregate")
    gen = torch.Generator(device=DEV).manual_seed(2024)
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    s0 = smp.smoothers[0]
    coeffs, fd, omega = s0._coeff6(), s0.fd_params, s0.omega
    x, b = randn(n, n, n), randn(n, n, n)
    out["#9"] = event_ms(torch, lambda: rg.fused_rb_gibbs_sweep_2d_staged(
        x, b, coeffs, omega, 1234, 77, fd_params=fd))
    out["#8 FD"] = event_ms(torch, lambda: rg.fused_rb_gibbs_sweep_2d(
        x, b, None, coeffs, omega, 1234, 77, fd_params=fd, staged=False))
    # a non-FD diagonal: the FD one times a field in [1.25, 1.75]
    d = _twin.fd_diag((n,) * 3, *fd, torch.float32, DEV) * (1.5 + 0.25 * torch.tanh(b))
    del b
    out["#8 streamed"] = event_ms(torch, lambda: rg.fused_rb_gibbs_sweep_2d(
        x, None, d, coeffs, omega, 1234, 77))
    del d
    z = randn(n // 2, n // 2, n // 2)
    args = (coeffs, fd[0], fd[1], omega, 1234, 77)
    kw = dict(z=z, with_xsum=True, with_zsum=True)
    out["#5"] = event_ms(torch, lambda: ms.fused_chain_down_2d_staged(x, None, *args, **kw))
    out["#4"] = event_ms(torch, lambda: ms.fused_chain_down_2d(x, None, *args, **kw))
    del x, z
    total = 0.0
    for o, sm in zip(smp.ops[1:-1], smp.smoothers[1:]):
        bl = randn(*o.grid_shape)
        a = (sm._coeff6(), sm.fd_params[0], sm.fd_params[1], sm.omega, 99, 5)
        total += event_ms(torch, lambda: ms.fused_zero_gibbs_restrict_fd(bl, *a), 20)
    out["#3 (6 levels)"] = total
    del smp
    out.update(time_small_kernels(torch, randn))
    return out


def v22_levels(torch, n):
    """[(shape, coeffs, (kappa2, hinv2), omega)] of every smoothed level of
    the gmrf_3d(n) V(2,2) hierarchy."""
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    smp = MGMCSampler.create(gmrf_3d(n, kappa=1.0, device=DEV), n_pre=2, n_post=2,
                             coarsest_size=128, coarsening="aggregate")
    return [(tuple(o.grid_shape), s._coeff6(), s.fd_params, s.omega)
            for o, s in zip(smp.ops, smp.smoothers)]


def time_small_kernels(torch, randn):
    """Device ms per call of #7 at every level below the plane limit of
    both V(2,2) hierarchies, #6 at 256^3, #11 at 256^3 and #10 at 128^3."""
    from parmgmc_tpu_torch.kernels import _twin
    from parmgmc_tpu_torch.kernels import patch_sweep as ps
    from parmgmc_tpu_torch.kernels import rb_gibbs as rg

    out = {}
    for n in (256, N_BIG):
        step = 0.0
        for shape, coeffs, fd, omega in v22_levels(torch, n):
            if shape[1] * shape[2] > rg._PLANE_LIMIT:
                continue  # level 0 at 768^3 runs #9
            x, b = randn(*shape), randn(*shape)
            t = device_ms(torch, lambda: rg.fused_rb_gibbs_sweep_fd(x, b, coeffs, *fd, omega, 1234, 77))
            out[f"#7 {shape[0]}^3"] = t
            step += 4 * t
            if shape == (256,) * 3:
                d = _twin.fd_diag(shape, *fd, torch.float32, DEV) * (1.5 + 0.25 * torch.tanh(b))
                out["#6 256^3"] = device_ms(torch, lambda: rg.fused_rb_gibbs_sweep(
                    x, None, d, coeffs, omega, 1234, 77))
                del d
            del x, b
        out[f"#7 {n}-v22 step"] = step
    h = 15.0**2  # chip_smoke.py phase 3's ragged shape
    x, b = randn(16, 24, 96), randn(16, 24, 96)
    out["#7 (16, 24, 96)"] = device_ms(torch, lambda: rg.fused_rb_gibbs_sweep_fd(
        x, b, [-h] * 6, 1.0, h, 1.3, 1234, 77))
    # the wrapper's host time a call, which a V(2,2) step pays 20 times
    x, b = randn(16, 16, 16), randn(16, 16, 16)
    out["#7 16^3 host us/call"] = host_us(torch, lambda: rg.fused_rb_gibbs_sweep_fd(
        x, b, [-h] * 6, 1.0, h, 1.3, 1234, 77))
    for n, fn, key in ((256, ps.fused_patch_sweep_sqfd_streamed, "#11 256^3"),
                       (128, ps.fused_patch_sweep_sqfd, "#10 128^3")):
        x = randn(n, n, n)
        h2 = float((n - 1) ** 2)
        out[key] = event_ms(torch, lambda: fn(x, None, 1.0, h2, 1234, 77))
        del x
    return out


# the segments the chain-plans drive times #1 on
CHAIN_SEGS = (2, 4, 6, 8, 12, 16, 24, 32, 40, 44, 48, 64)


def time_chain_plans(torch):
    """Device ms of #1 at 256^3, 128^3 and (16, 24, 96) on each even
    segment of CHAIN_SEGS."""
    from unittest import mock

    from parmgmc_tpu_torch.kernels import _march
    from parmgmc_tpu_torch.kernels import mg_sweep as ms

    calls, _ = main_path_kernels(torch)
    out = {}
    for name, shape, fn in calls:
        if not name.startswith("#1"):
            continue
        chosen = ms.chain_fd_plan(shape, with_z=True)
        for seg in sorted({min(s, shape[0]) for s in CHAIN_SEGS} | {chosen.seg}):
            plan = _march.MarchPlan(shape=shape, strip=chosen.strip, halo=chosen.halo, seg=seg,
                                    tma=chosen.tma)
            with mock.patch.object(ms, "chain_fd_plan", lambda s, with_z=False, p=plan: p):
                t = device_ms(torch, fn)
            mark = " (rule)" if seg == chosen.seg else ""
            out[f"#1 {shape} seg {seg}{mark}"] = t
    return out


# the segments the sweep-plans drive times #7 on
PLAN_SEGS = (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96)


def time_sweep_plans(torch):
    """Device ms of #7 (b, noise) with each segment length of PLAN_SEGS at
    every level shape of both V(2,2) hierarchies below the plane limit."""
    from unittest import mock

    from parmgmc_tpu_torch.kernels import _march
    from parmgmc_tpu_torch.kernels import rb_gibbs as rg

    gen = torch.Generator(device=DEV).manual_seed(2025)
    cases = [c for n in (256, N_BIG) for c in v22_levels(torch, n)
             if c[0][1] * c[0][2] <= rg._PLANE_LIMIT]
    h = 15.0**2
    cases.append(((16, 24, 96), [-h] * 6, (1.0, h), 1.3))
    out = {}
    for shape, coeffs, fd, omega in cases:
        x = torch.randn(*shape, generator=gen, device=DEV)
        b = torch.randn(*shape, generator=gen, device=DEV)
        chosen = rg.full_sweep_plan(shape)
        for seg in sorted({min(s, shape[0]) for s in PLAN_SEGS} | {chosen.seg}):
            plan = _march.MarchPlan(shape=shape, strip=chosen.strip, halo=chosen.halo, seg=seg,
                                    tma=chosen.tma)
            with mock.patch.object(rg, "full_sweep_plan", lambda s: plan):
                t = device_ms(torch, lambda: rg.fused_rb_gibbs_sweep_fd(
                    x, b, coeffs, *fd, omega, 1234, 77))
            mark = " (rule)" if seg == chosen.seg else ""
            out[f"#7 {shape} seg {seg}{mark}"] = t
        del x, b
    return out


def time_patch_kernels(torch):
    """Device ms of #11 at 256^3 and 128^3 and #10 at 128^3 with the noise
    on and off and b given and None."""
    from parmgmc_tpu_torch.kernels import patch_sweep as ps

    gen = torch.Generator(device=DEV).manual_seed(2026)
    out = {}
    for n, fn, key in ((256, ps.fused_patch_sweep_sqfd_streamed, "#11"),
                       (128, ps.fused_patch_sweep_sqfd, "#10"),
                       (128, ps.fused_patch_sweep_sqfd_streamed, "#11")):
        x = torch.randn(n, n, n, generator=gen, device=DEV)
        b = torch.randn(n, n, n, generator=gen, device=DEV)
        h2 = float((n - 1) ** 2)
        for bb, tag in ((None, "b=None"), (b, "b")):
            for noise in (True, False):
                out[f"{key} {n}^3 {tag} noise {'on' if noise else 'off'}"] = event_ms(
                    torch, lambda: fn(x, bb, 1.0, h2, 1234, 77, with_noise=noise))
        del x, b
    return out


def run_one(root, drives, repeats):
    """{metric: [numbers]} of every drive in the port in ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    res = {}
    for drive in drives:
        if drive == "kernels":
            res.update({k: [v] for k, v in time_kernels(torch).items()})
        elif drive == "chain-plans":
            res.update({k: [v] for k, v in time_chain_plans(torch).items()})
        elif drive == "sweep-plans":
            res.update({k: [v] for k, v in time_sweep_plans(torch).items()})
        elif drive == "patch-kernels":
            res.update({k: [v] for k, v in time_patch_kernels(torch).items()})
        elif drive in PATCH_CHAINS:
            res[f"{drive} ms/sweep"] = time_patch_chain(torch, drive, repeats)
        elif drive in MESH_CHAINS:
            res.update(time_mesh_chain(torch, root, drive, repeats))
        elif drive in ("matern-256", "ex7-256"):
            res.update(time_matern(torch, drive, repeats))
        elif drive == "sharded-256":
            res.update(time_sharded(torch, repeats))
        elif drive == "graph-sharded":
            res.update(time_graph_sharded(torch, root, repeats))
        else:
            res.update(time_chain(torch, drive, repeats))
        torch.cuda.empty_cache()
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="checkout roots to compare")
    ap.add_argument("--drive", nargs="+", choices=DRIVES, default=["256-v10"])
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3, help="windows a chain drive and run")
    ap.add_argument("--out", help="also write the result JSON here")
    ap.add_argument("--run", help=argparse.SUPPRESS)  # one run, in a child process
    args = ap.parse_args()
    if args.run:
        print(json.dumps(run_one(args.run, args.drive, args.repeats)))
        return 0
    trees = args.trees
    order = []
    for p in range(args.pairs):
        order += trees if p % 2 == 0 else trees[::-1]
    runs = {t: [] for t in trees}
    for i, t in enumerate(order):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", t, "--repeats",
             str(args.repeats), "--drive", *args.drive],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs[t].append(got)
        print(f"run {i + 1}/{len(order)} {t}: " + "; ".join(
            f"{k} " + " ".join(f"{v:.4f}" for v in vs) for k, vs in got.items()), flush=True)
    summary = {}
    for t, rs in runs.items():
        summary[t] = {}
        for key in rs[0]:
            every = [v for r in rs for v in r[key]]
            summary[t][key] = dict(median=statistics.median(every), min=min(every),
                                   max=max(every), n=len(every))
            print(f"{t} {key}: median {summary[t][key]['median']:.4f} over {len(every)}, "
                  f"range {min(every):.4f}..{max(every):.4f}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    result = {"card": card, "drives": args.drive, "order": order,
              "runs": runs, "summary": summary}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
