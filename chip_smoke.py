#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (parmgmc_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device  -- requires torch.cuda; prints nvidia-smi's name and power limit.
2. build   -- compiles csrc/*.cu with nvcc (sm_90a, one nvcc per source,
              all started together) and prints ptxas' report; times a
              1 GiB device copy (the card's reachable memory rate).
3. kernels -- each CUDA kernel against its plain-torch twin on the card, at
              the main paths' shapes and coefficients (every level) and at a
              small shape; deterministic
              outputs to 1e-5, noisy outputs and partial sums to 1e-4
              (relative max-norm); twin device times per call from
              torch.profiler.  #1 bit for bit #5 (b given, and b = None
              with z) with its launch plan; #1 and #2 timed at the main
              path's shapes (calls queued behind a sleeping kernel), with
              #2's launches a call (exactly one) and #3 over the same four
              levels beside it.  The full sweep runs in both modes (FD
              diagonal, #7; streamed diagonal, #6, with the FD diagonal
              times a smooth field in [1, 2]), forward and backward, noise
              on and off, b given and None; #7 (b, noise) timed at every
              level (calls queued behind a sleeping kernel) with its
              launch plan.
4. moments -- bench.py's selftest problem (16x16x128, b = 50): the keyed
              kernel chain against the explicit-noise plain chain over 12000
              steps after 200 burn-in (max |z| < 10, mean |z| < 2.5, max
              relative variance gap < 0.2).
5. deferred-- sample_chain_deferred bit-identical to sample_chain (8 steps;
              the deferred step captured in CUDA graphs on its first step
              and replayed on the other seven).
6. main    -- gmrf_3d(256), MGMC V(1,0), aggregate hierarchy, coarsest 512
              DOF, prior (b = None) through sample_chain_deferred: ms/cycle
              over 512 steps, tau and ESS/sec from a 4096-step mean-QOI
              chain, exactly one #1 and one #2 launch a step and no other
              kernel, every step a replay of the captured step,
              the exact law of the QOI: mean(x) ~ N(0, 1/(kappa^2 N)),
              the device time of a step by kernel, and the same keyed
              cycle with the twins in place of the kernels.
7. moments V(2,2) and Gibbs -- the keyed V(2,2) chain on the phase-4
              problem (4000 steps), and the keyed Gibbs chain on a
              16x16x32 problem with kappa^2 = 900 (6000 steps; FD
              symmetric sweeps, and forward sweeps of the streamed
              diagonal), each against its explicit-noise chain with the
              gates of phase 4.
8. V(2,2)  -- gmrf_3d(256), MGMC V(2,2), the same hierarchy, the general
              keyed cycle through sample_chain with the mean as QOI:
              ms/cycle over 512 steps, tau and ESS/sec from 4096 steps,
              var(QOI) N in (0.8, 1.25), exactly 20 FD-sweep launches per
              step (5 smoothed levels x 4 sweeps) and no other kernel, the
              device time of a step by kernel, and the cycle on the twins.
9. Gibbs   -- the keyed Gibbs chain at 256^3 (b = None), forward and
              symmetric, FD (#7) and streamed diagonal (#6): wall ms per
              sweep and the launches of each mode.
10. patch kernels -- the patch sweep kernels, whole-sweep cooperative
              (#10) and per phase (#11), against their twin on the squared
              prior (kappa = 1) at 128^3 and 256^3 and at (11, 12, 13),
              noise on and off, b given and None (1e-4 relative max-norm
              either way), #10 and #11 bit for bit against each other and
              against the colour-by-colour check (one launch a colour);
              device times per call.
11. patch moments -- bench.py's patch problem (16x10x128, kappa = 40,
              b = 5): the keyed chain through #10 and again through #11
              (the size rule patched), 4000 steps each, against one
              explicit-noise chain of 1000 steps (50 burn-in each),
              two-sample SE (max |z| < 10, mean |z| < 2.5, max relative
              variance gap < 0.35).
12. patch path -- squared_shifted_laplace_fd at 256^3 (route #11) and
              128^3 (route #10), PatchGibbsSampler, sample_chain with the
              mean as QOI, b = None: wall ms per sweep, device time per
              sweep (CUDA events) and idle share, host enqueue time per
              sweep, exact launch counts, a finite chain.

13. large-plane kernels -- the marching kernel's three modes, #5 and #4
              against their twins at (32, 768, 768), (12, 770, 772) and
              (12, 770, 774) (rows not a multiple of 16 B: the cp.async
              producer) (forward and backward, noise on and off, b given
              and None with z and the sums; tolerances as phase 3) and bit for
              bit against each other, #3 against its twin at every level of
              the 768^3 hierarchy below 0 and at (8, 10, 128), #3(b) bit for
              bit #5(0, b); at 768^3 (the main path's call: b = None, z, sums,
              noise) #5 and #4 against their twins (1e-4, partial sums
              elementwise) and against #1 (1e-6); device times (CUDA events)
              of #5, #4, #1 and the twin at 768^3, of #3 per level and of the
              tail kernel forced over the same levels; the launch geometry,
              blocks an SM and waves of each timed launch.
14. large-plane moments -- bench.py selftest2d's problem ((32, 768, 768),
              kappa = 1, b = 50): the keyed chain (#4 at level 0, #3 below,
              exact launch counts) against the explicit-noise chain, 4000
              steps after 100 burn-in each (max |z| < 14, mean |z| < 2.5, max
              relative variance gap < 0.3); sample_chain_deferred (#5) bit for
              bit sample_chain (#4) over 8 steps.
15. 768^3 main path -- gmrf_3d(768), MGMC V(1,0), coarsest 128 (6^3), prior
              through sample_chain_deferred: ms/cycle over 128 steps, tau and
              ESS/sec from 2048 steps, var(QOI) N in (0.8, 1.25), exactly one
              #5 and six #3 launches a step and no other kernel, every step
              a replay of the captured step, the device time of a step by
              kernel and the idle share.
16. large-plane sweep kernels -- the marching sweep's two entries, #9 and
              #8 (FD, and streamed D: the FD diagonal times a smooth field in
              [1, 2]), against their twins at (32, 768, 768), (12, 770, 772),
              (12, 770, 774) and 768^3 (forward and backward, noise on and off,
              b given and None; tolerances as phase 3); #9 == #8 (FD) == #7 and
              #8 (streamed) == #6 bit for bit at each shape (the whole-plane
              kernels forced past the plane limit); device times (CUDA events)
              of #9, #8 (FD), #7, #8 (streamed), #6 and the twins at 768^3; the
              launch geometry, blocks an SM and waves; #7 (b, noise) at each
              level below 0 of the 768^3 V(2,2) hierarchy, with its plan.
17. large-plane sweep moments -- phase 7's problems with the plane limit
              patched below their finest plane: V(2,2) (#9 at level 0), Gibbs FD
              symmetric (#9) and Gibbs streamed forward (#8), each against phase
              7's explicit-noise chain with the phase-4 gates, exact launch
              counts, and moments bit for bit phase 7's kernel chain; the
              (32, 768, 768) keyed V(2,2) chain (#9 at level 0) bit for bit the
              chain with level 0 forced to #7 over 8 steps.
18. 768^3 V(2,2) and Gibbs -- gmrf_3d(768), MGMC V(2,2), coarsest 128,
              through sample_chain with the mean as QOI: ms/cycle over 32
              steps, tau, ESS/sec and var(QOI) N in (0.8, 1.25) from 512
              steps, exactly four #9 and 24 #7 launches a step (level 0 past
              the plane limit, six levels below it) and no other kernel, the
              device time of a step by kernel and the idle share; the keyed
              Gibbs chains at 768^3 (b = None): FD forward (one #9 a sweep),
              FD symmetric (two) and streamed forward (one #8), wall ms per
              sweep and exact launches.
19. posterior gates -- bench.py's LRC selftest problem (16x16x128, three
              ball observations, sigma^2 = 0.05, radii 0.2, default_rng(5)),
              MGMC V(1,0): the probed route engaged (lrc_aux.probe; the
              coarse and fine unions packed wherever every member has a
              window view); the
              keyed step against its materialised form under the same keys
              (testing.lrc_chain_oracle), probed and b_eff routes, b = f and
              None (< 1e-3 relative max-norm); the deferred chain against
              sample_chain over 8 steps (state and QOI < 1e-3); the keyed
              chain against its explicit-noise chain, 20000 steps after 200
              burn-in (the phase-4 gates); the keyed LRC Gibbs chain
              (kappa = 40 base, dense B, symmetric sweeps) against its
              explicit-noise chain, 20000 steps after 500 burn-in (variance
              gap < 0.25); exact launches of each chain (one #1 and one #7 a
              MGMC step, two #7 a Gibbs step; none in the explicit chains).
20. 256^3 posterior path -- bench.py --posterior's problem (gmrf_3d(256),
              five balls of radius 0.12, sigma^2 = 0.01, default_rng(0)),
              MGMC V(1,0) through sample_chain_deferred with b = f: set-up
              time by part, the probed route with both union packs,
              ms/cycle over 512 steps, tau and ESS/sec from 4096 steps, the
              exact law of the QOI (mean and variance of mean(x) under the
              posterior, from the base's eigenvectors in float64), exactly
              one #1 and four #7 launches a step and no other kernel, every
              step a replay of the captured step, the device time of a step
              by kernel and the idle share, a finite state, and the same
              keyed steps, eager, on the twins over 8 steps (state < 1e-4).

21. linear hierarchy -- build_hierarchy(gmrf_3d(n)) with every default
              (coarsening="linear": GeometricTransfer, the comb-probed
              Galerkin product, compress_stencil) at 256^3 and 768^3: set-up
              time by level, the offsets each level keeps and how many of
              them are fields, peak device memory; at both sizes the coarse
              stencils of levels 1 and 2 against R(A(P x)) on three seeded
              fields (< 1e-5 relative max-norm); no chain at 768^3.  The keyed
              default V(2,2) chain on gmrf_3d(16) (16^3 on #7, 8^3 the exact
              coarse sample of the Galerkin operator) against its
              explicit-noise chain, 20000 steps after 200 burn-in (the
              phase-4 gates), with exact launches (four #7, two residual
              launches and one prolong-add a step; none in the explicit
              chain).  Odd extents:
              gmrf_3d(129) V(2,2) linear (129 -> 65 -> 33 -> 17 -> 9): the
              residual kernel (csrc/residual_restrict.cu) bit for bit its
              twin on every level, both forms, b given and None, and the
              prolong-add kernel (csrc/prolong_add.cu) bit for bit its twin
              on every level, into a new tensor, a separate buffer and y;
              eight keyed
              steps against the same steps on the twins (< 1e-4), exactly
              four #7, twelve 27-point sweeps, five residual launches and
              four prolong-adds a
              step and no other kernel, one chain_step_graph a replayed
              step, a finite state; gmrf_3d(33) V(2,2) aggregate (the probed
              17^3 and 9^3 levels have coefficient fields, the plain route):
              exactly four #7 a step.  Fault F3: a two-level linear V(1,0)
              sampler is not deferred-eligible, its keyed step launches one
              #7, two residual launches, one prolong-add and no #1, #2 or #3,
              and step_deferred refuses it.
22. 256^3 default V(2,2) path -- MGMCSampler.create(gmrf_3d(256), n_pre=2,
              n_post=2) with no device and every other argument at its
              default (the linear hierarchy 256^3 ... 8^3; levels 128^3 ...
              16^3 are 27-point stencils on the 27-point colour-sweep kernel):
              the residual kernel bit for bit its twin on every level, both
              forms, b given and None, and a step's six calls timed (queued
              behind a sleeping kernel) beside the twin and their bound; the
              prolong-add kernel likewise, bit for bit on every level in its
              three out forms and a step's five calls timed;
              then through sample_chain with the mean as QOI, its step replayed
              from a captured CUDA graph: ms/cycle over 64 steps after a
              warm-up, tau and ESS/sec and var(QOI) N in (0.8, 1.25) from
              N_LINEAR_IACT steps, exactly four #7 launches, sixteen
              27-point sweeps, six residual launches and five prolong-adds a
              step and no other
              kernel, the device time of
              a step by kernel and the idle share, and eight keyed steps on
              the twins (state < 1e-4).
23. unstructured mesh set-up -- MaternMeshSampler on the wrench
              (examples/benchmark/wrench.json: kappa 5) at refine 3 (38,132
              DOFs): the preset's posterior (three balls, sigma^2 = 1e-6) in
              float64 and the prior in float32, and at refine 4 (277,544 DOFs)
              the prior in float64, all on the card, MGMC V(1,1) on the
              algebraic hierarchy (coarsest 128 requested): the host seconds
              of each set-up stage (read and refine, assembly, colouring,
              upload, aggregation), the levels, colours and ELL widths, the
              peak device memory of the set-up (above what was held before
              it); the native colouring and aggregation bit
              for bit their Python twins on refine 3.
24. unstructured mesh gates -- the exact laws from the host's
              SparseCholeskySampler (SuperLU LDL^T, float64; Woodbury for the
              posterior); 256 chains chain-major after 16 burn-in steps, 96
              recorded steps each: the posterior's QOI (the preset's rect-region
              mean) within 4 standard errors of its exact mean (SE = sqrt(var
              tau / N)) with variance / exact in (0.8, 1.25), the posterior's
              field mean against A_post^-1 b (relative 2-norm error < 0.02, the
              strict end of the reference's 0.02-0.10); the same variance gate
              for the float32 prior, for hierarchy="geometric" (refine 3 over
              the refinement chain, four levels), and for GraphPatchGibbsSampler
              on the refine-2 prior (5,682 DOFs; 8 burn-in and 32 recorded
              sweeps).
25. unstructured mesh path -- the refine-3 posterior with one chain
              (MaternMeshSampler.sample): ms/cycle over 1024 steps, tau (emcee
              window, c = 5), tau_sections, ESS/sec; with 256 chains
              chain-major (sample_chains), and the float32 prior likewise: ms a
              step over 256 steps, aggregate samples/s, mean tau over chains,
              tau_sections; the refine-4 prior with one chain: ms/cycle over
              256 steps; for each, the device time a step by kernel and the
              idle share (profiler) and the torch ops a step (a dispatch
              mode); no port kernel is launched (the JAX mesh path reaches no
              Pallas kernel).
26. structured Matérn façade, 256^3 -- MaternSampler((256,) * 3, kappa=1,
              float32) with no device argument on the aggregate V(1,0)
              hierarchy (coarsest 128 requested), its describe() text;
              sample(512, burnin=16) with the mean as QOI (b = zeros):
              exactly one #1 and one #2 launch a step and no other kernel,
              the QOI's variance N in (0.7, 1.3) and its mean within
              5 sqrt(tau / (512 N)) of 0 (the exact law: A 1 = kappa^2 1,
              so Var mean(x) = 1 / (kappa^2 N)), tau, ms a step and
              ess_per_sec; sample_mean_and_var(64): finite fields and a
              pooled mean within 5 sqrt(tau / (64 N)) of 0; a checkpoint
              (save_chain_state, load_chain_state) and one step from each
              copy, bit for bit; cg_solve's iteration (tol 1e-5, at most
              2000 iterations, the SSOR preconditioner) on b = 1 in float64
              within a relative 1e-3 (2-norm) of the exact A^-1 1 = 1 /
              kappa^2, and in float32 printed beside it, each with its
              time and iterations; 20 Richardson iterations in float32
              (finite residuals, printed with their time); the VTK file of
              a 64^3 block of the mean.
27. ex7 flow, 256^3 -- sample_until_converged on the same sampler with b =
              1, the mean as QOI, 8 chains, check_every 50, method "rank",
              overdispersion 1e3, at most 2000 steps: it converges, every
              chain step launched exactly one #1 and one #2 (8 x steps of
              each, no other kernel), the pooled mean QOI of the last half
              within 5 sqrt(tau / (8 n N)) of 1 / kappa^2 = 1, rhat_rank,
              ess_bulk and ess_tail of the traces, wall seconds; then the
              façade's sample_chains(256, n_chains=4, burnin=16): shape (4,
              256), each chain's QOI variance N in (0.7, 1.3), exactly
              4 x 272 launches of #1 and of #2; last, profiling.trace of 4
              steps, whose Chrome trace names both kernels.
28. the kernels on shards -- #7, #1 (256^3) and #3 (128^3, level 1) on
              halo-extended blocks (shards 0, 1 and 3 of 4; halos of 2, 4
              and 2 rows) with row_offset / n0_global, noise on: the kept
              rows bit for bit the full-grid kernel's, each block against
              its twin on the same block (1e-4); then #8, #9, #4 and #5 on
              the 16-row shards of phase 14's (32, 768, 768) grid the same
              way.
29. the sharded path, 256^3 -- parallel.fused.make_sharded_mgmc_step on
              the aggregate V(1,0) sampler on 1, 2 and 4 slots (cuda:0, or
              distinct cards where the machine has them), b = None: exactly
              S #1 and S #3 launches a step (levels 0 and 1 sharded) and no
              twin, the noise-on state after 3 steps bit for bit the same at
              every S, noise off against step_with_noise with zero noises
              (1e-5), ms a step beside the unsharded MGMCSampler.step (the
              machinery overhead), the device time of a step (queued behind
              a sleeping kernel) and the idle share; at S = 4 a 512-step
              chain after 16 burn-in: var(QOI) N in 1 +- 0.3 and its mean
              within 5 SE of 0; phase 20's posterior on 4 slots: noise off
              against step_with_noise (5e-5), four #1 a step and no other
              kernel, the QOI's exact law (variance in 1 +- 0.3 of it, mean
              within 5 SE) over 512 steps; make_sharded_gibbs_step at 256^3
              on 4 slots, one step in each halo mode: the frozen step's
              block interiors (two rows in from each block edge) equal the
              exact step's.
30. the sharded wrench -- parallel.graph_sharded on 1, 2 and 4 slots
              with phase 23's refine-3 posterior (float64), refine-3 prior
              (float32) and refine-4 prior (float64): each partition's rows
              a slot, colours, nbr_shifts and ghost rows received; the
              deterministic sharded MGMC step against the unsharded
              step_with_noise with zero noises (1e-10 relative in float64,
              5e-5 in float32); "neighbor" and "allgather" ghosts agree at
              4 slots (1e-12); 256 chains chain-major of the posterior on 4
              slots through phase 24's gates (16 burn-in, 96 recorded
              steps: QOI mean within 4 SE, variance / exact in (0.8, 1.25));
              ms a step with 256 chains at S = 1, 2, 4 beside the unsharded
              step (medians of three 32-step windows), device busy (the
              profiler's kernel time) and the idle share; no port kernel.
31. shard_sampler -- ex13's structured weak-scaling configuration at
              --base 128: shifted_laplace_fd((128 S, 128, 128), 1), float32,
              MGMC V(1,1), coarsest 128, grid_axes ("x", None, None), on S =
              1, 2, 4 slots: step_with_noise against the unsharded one under
              the same noises (1e-5), the keyed step bit for bit the
              unsharded plain (lax_variant) keyed step, ms a step (median of
              three windows of 8 steps) beside the unsharded plain step,
              device busy (profiler) and idle share; one keyed step of the README quick
              start at 256^3 (linear V(2,2)) on 4 slots against the
              unsharded plain step (1e-5); no port kernel.
32. the dry run -- parallel.dryrun.dryrun_multichip(4) on 4 slots of
              cuda:0: shard_sampler on a (chain, x) mesh, the sharded chain
              kernels (prior and posterior, 5e-5), the frozen-halo step
              (1e-5), the row-partitioned mesh MGMC (prior and posterior,
              5e-5); its kernel launches.
33. the examples -- each ported example's main (parmgmc_tpu_torch.examples)
              called in this process on the card with its sample counts cut
              (each cut printed beside the JAX default; EXAMPLE_RUNS), every
              example's own acceptance assert: ex1 (cholesky, gibbs, gibbs
              symmetric, mgmc), ex4 (woodbury, mgmc), ex9, ex7, ex2
              with a VTK file, ex13_cholsampler at refine 2 with an MGMC
              cross-check, ex13_weak_scaling on 1 and 2 slots in its three
              modes, benchmark_matern on the wrench preset with 256 chains and
              --anchor-ranks 4, baseline_cpu_reference at edge 128, and
              make_meshes into a temporary directory, its files byte for byte
              data/*.msh; the launch counters unchanged across the phase (the
              JAX scripts reach no Pallas kernel).

Each phase prints its wall time.  The last lines are the kernels' JSON
record (launches from the main paths that run each kernel: phases 6, 26,
27, 29 and 32 for the chain kernel, 6, 26 and 27 for the tail kernel, phases 8 and 22 for the FD sweep, phase 9 for the
streamed sweep, phase 12 for the patch sweeps, phase 14 for #4, phases 15
and 29 for #3, phase 15 for #5, phase 18 for #9 and #8; bound_ms from this run's shapes
at the card's published peaks), the card as nvidia-smi prints it, and
{"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

N_MAIN = 256
N_TIME = 512
N_IACT = 4096
N_MOMENTS = 12_000
N_MOMENTS_V22 = 4_000
N_MOMENTS_GIBBS = 6_000
N_GIBBS_TIME = 256
N_PATCH_MOMENTS = 4000
N_PATCH_PLAIN = 1000
N_PATCH_TIME = 32
N_BIG = 768
N_BIG_TIME = 128
N_BIG_IACT = 2048
N_MOMENTS_2D = 4000
N_BIG_V22_TIME = 32
N_BIG_V22_IACT = 512
N_BIG_GIBBS = 32
N_POST_MOMENTS = 20_000
N_LINEAR_TIME = 64
N_LINEAR_IACT = 512
POST_V10 = dict(n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate")
# the unstructured-mesh phases (wrench, examples/benchmark/wrench.json)
WRENCH_PRESET = "examples/benchmark/wrench.json"
N_MESH_CHAINS = 256
N_MESH_BURNIN = 16
N_MESH_GATE = 96
N_PATCH_BURNIN = 8
N_PATCH_GATE = 32
N_MESH_WARM = 8
N_MESH_1CHAIN = 1024
N_MESH_PATH = 256
N_MESH4_TIME = 256
# the structured Matérn façade and the ex7 flow (phases 26 and 27)
N_MATERN = 512
N_MATERN_BURNIN = 16
N_MATERN_MOMENTS = 64
MATERN_VAR_GATE = 0.3  # var(QOI) N in 1 +- 0.3: ~5 standard errors at 512 draws, tau ~ 1
N_EX7_CHAINS = 8
N_EX7_CHECK = 50
N_EX7_MAX = 2000
N_FACADE_CHAINS = 4
N_FACADE_STEPS = 256
N_TRACE_STEPS = 4
N_RICHARDSON = 20
VTK_BLOCK = 64
# the sharded path (phases 28 and 29): slots on one card, or on distinct
# cards where the machine has them
SHARD_COUNTS = (1, 2, 4)
SHARDS_MAX = 4
N_SHARD_TIME = 64
N_SHARD_QOI = 512
SHARD_VAR_GATE = 0.3  # var(QOI) in exact * (1 +- 0.3) at 512 draws, as phase 26
# phases 30 and 31: the sharded wrench (windows of 32 steps) and
# shard_sampler on ex13's weak-scaling grids (128 S, 128, 128)
N_SHARD_GRAPH = 32
SHARD_BASE = 128
N_SHARD_SAMPLER = 8
SHARD_WINDOWS = 3
# the reference's relative sample-mean error bound is 0.02-0.10 (BASELINE.md):
# the strict end; one posterior sample is ~0.41 |mu| away from the mean in
# 2-norm (the exact law), so 256 x 96 samples expect ~0.003
MESH_FIELD_GATE = 0.02
# phase 33: (label, example module, argv, the cut beside the JAX default);
# the whole phase ~35 s, the smoke run's 1200 s being nearly spent by
# phases 1-32 (82 s before these cuts on an H100 80GB HBM3 at 700 W; ex4
# gibbs is left out: 12000 samples took 10.4 s there for a relative error
# of 0.039 against its 0.05 bound, which the CPU tests hold; ex9 at kappa
# 1, where 100 samples erred 0.005 on the host against 0.025 at kappa 2)
_PRESET_WRENCH = "examples/benchmark/wrench.json"
EXAMPLE_RUNS = (
    ("ex1 cholesky", "ex1_samplers", ["--sampler", "cholesky", "--samples", "3000", "--kappa", "3"],
     "3000 samples at kappa 3 (JAX default 100000 at kappa 10)"),
    ("ex1 gibbs", "ex1_samplers", ["--sampler", "gibbs", "--samples", "5000", "--kappa", "3"],
     "5000 samples at kappa 3 (JAX default 100000 at kappa 10)"),
    ("ex1 gibbs-symmetric", "ex1_samplers", ["--sampler", "gibbs-symmetric", "--samples", "3000", "--kappa", "3"],
     "3000 samples at kappa 3 (JAX default 100000 at kappa 10)"),
    ("ex1 mgmc", "ex1_samplers", ["--sampler", "mgmc", "--samples", "500", "--kappa", "1"],
     "500 samples at kappa 1 (JAX default 100000 at kappa 10)"),
    ("ex4 woodbury", "ex4_posterior", ["--sampler", "woodbury", "--samples", "2000"],
     "2000 samples (JAX default 50000)"),
    ("ex4 mgmc", "ex4_posterior", ["--sampler", "mgmc", "--samples", "1500"], "1500 samples (JAX default 50000)"),
    ("ex9", "ex9_squared_prior", ["--samples", "50", "--kappa", "1"],
     "50 samples at kappa 1 (JAX default 30000 at kappa 2)"),
    ("ex7", "ex7_convergence", [], "the JAX defaults"),
    ("ex2", "ex2_matern_iact", ["--samples", "500", "--vtk", "{tmp}/ex2.vtk"],
     "500 samples and 200 moment steps (JAX defaults 20000 and 5000)"),
    ("ex13_cholsampler", "ex13_cholsampler", ["--refine", "2", "--samples", "64", "--mgmc-samples", "300"],
     "refine 2, 300 MGMC samples (JAX documented: refine 4; refine 3 with 2000)"),
    ("ex13_weak_scaling", "ex13_weak_scaling", ["--devices", "1", "2", "--samples", "16"],
     "slots 1 2, 16 samples (JAX defaults 1 2 4 8, 64)"),
    ("ex13_weak_scaling chains", "ex13_weak_scaling", ["--devices", "1", "2", "--samples", "16", "--unstructured"],
     "slots 1 2, 16 samples (JAX defaults 1 2 4 8, 64)"),
    ("ex13_weak_scaling dd posterior", "ex13_weak_scaling",
     ["--devices", "1", "2", "--samples", "16", "--unstructured", "--domain-decompose", "--posterior"],
     "slots 1 2, 16 samples (JAX defaults 1 2 4 8, 64)"),
    ("benchmark_matern", "benchmark_matern",
     ["--preset", _PRESET_WRENCH, "--chains", "256", "--burnin", "50", "--samples", "250", "--anchor-ranks", "4"],
     "50 + 250 steps of 256 chains (JAX defaults 1000 + 10000)"),
    ("baseline_cpu_reference", "baseline_cpu_reference", ["128"], "edge 128, the JAX default"),
    ("make_meshes", "make_meshes", ["--outdir", "{tmp}"], "into a temporary directory, not data/"),
)
N_EX2_MEAN_VAR = 200  # ex2's moments run (the JAX script's constant: 5000)
RAGGED_BIG = (12, 770, 772)  # a large plane whose extents the strips do not divide
# and one whose rows are not a multiple of 16 B: the marching kernels' cp.async producer
RAGGED_ODD = (12, 770, 774)

# the card's peaks (NVIDIA's H100 SXM data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# float operations per grid cell, counted from each twin's arithmetic
# (noise: Box-Muller 26 + scaling 4; sweep: neighbour sum 11 + update 5;
# A v: 13; link-count diagonal: 2)
FLOPS_CHAIN = 79  # A x + residual 15, noise 30, sweep 15, A y 13, adds/sums/D 6
FLOPS_TAIL = 62  # noise 30, sweep 15, A y 13, residual/restriction/D 4
FLOPS_SWEEP = {"fd": 48, "streamed": 46}  # noise 30, sweep 16, D 2 (FD only)
# one patch, and so one grid point, per sweep: F x on 25 points 250, F(F x)
# and the residual at 7 members 77, A_SS 46, rhs 98, Cholesky 140, the two
# solves 105, 7 Box-Muller draws 182
FLOPS_PATCH = 898


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel_err(got, want):
    d = (got.double() - want.double()).abs().max().item()
    return d / max(want.double().abs().max().item(), 1e-30), d


def bound(nbytes, nflops):
    """(ms, what bounds it): the least time the card could take to move
    nbytes once and do nflops float32 operations."""
    tb, tf = nbytes / HBM_BYTES_PER_S, nflops / F32_FLOPS_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def smooth_field(torch, shape, dev):
    """A smooth positive field in [1, 2] on the grid."""
    n0, n1, n2 = shape
    i = torch.arange(n0, device=dev).reshape(n0, 1, 1) / n0
    j = torch.arange(n1, device=dev).reshape(1, n1, 1) / n1
    k = torch.arange(n2, device=dev).reshape(1, 1, n2) / n2
    return 1.5 + 0.5 * torch.sin(2 * math.pi * (i + 0.5 * j)) * torch.cos(2 * math.pi * k)


def field_operator(torch, op):
    """op with its diagonal times smooth_field: a 3D star stencil with
    scalar off-diagonals that is not link-count FD (the streamed-diagonal
    sweep's operator)."""
    from parmgmc_tpu_torch.operators.stencil import StencilOperator

    diag = (op.diag * smooth_field(torch, op.grid_shape, op.diag.device)).contiguous()
    return StencilOperator(offsets=op.offsets, coeffs=op.coeffs, diag=diag)


def copy_rate(torch, dev):
    """Bytes/s of a 1 GiB device-to-device copy (read + write), CUDA events."""
    x = torch.empty(2**28, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    y.copy_(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        y.copy_(x)
    end.record()
    torch.cuda.synchronize()
    return 2 * x.numel() * 4 / (start.elapsed_time(end) / 10 * 1e-3)


def device_ms(torch, fn, n):
    """(device ms per call, {kernel name: device ms per call}) of fn over
    n calls after one warm-up: the profiler's summed device time of every
    kernel fn launched (host launch gaps excluded)."""
    total, per = profiled_ms(torch, fn, n)
    check(total > 0, "the profiler saw no device time")
    return total, per


def profiled_ms(torch, fn, n):
    """:func:`device_ms`, (0.0, {}) where the profiler saw no device time.
    Times steps of more launches than the launch queue holds, which
    :func:`queued_ms` cannot: the host blocks behind the sleeping kernel
    and its window times the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per = {}
    for a in prof.key_averages():
        if a.device_type == torch.autograd.DeviceType.CUDA and a.self_device_time_total > 0:
            name = a.key.replace("(anonymous namespace)::", "")[:72]
            per[name] = per.get(name, 0.0) + a.self_device_time_total / 1e3 / n
    return sum(per.values()), per


def phase_kernels(torch, dev, main_smp, v22_smp):
    from parmgmc_tpu_torch.kernels import mg_sweep, mg_tail

    rec = {}
    gen = torch.Generator(device=dev).manual_seed(123)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)

    # chain kernel: the main path's level 0, plus a small ragged-tile shape
    s0 = main_smp.smoothers[0]
    for shape, main in (((N_MAIN,) * 3, True), ((16, 24, 96), False)):
        x, b = randn(*shape), randn(*shape)
        z = randn(*(s // 2 for s in shape))
        hinv2 = float((shape[0] - 1) ** 2)
        args = (s0._coeff6(), s0.fd_params[0], s0.fd_params[1], s0.omega, 1234, 77) if main \
            else ([-hinv2] * 6, 1.0, hinv2, 1.0, 1234, 77)
        worst = 0.0
        for noise, bb, zz in ((False, b, None), (False, None, z), (True, None, z), (True, b, None)):
            kw = dict(with_noise=noise, z=zz, with_xsum=True, with_zsum=zz is not None)
            got = mg_sweep.fused_chain_down_fd(x, bb, *args, **kw)
            want = mg_sweep.fused_chain_down_fd_reference(x, bb, *args, **kw)
            torch.cuda.synchronize()
            names = ["xpy", "rc", "xsum", "zsum"][: len(got)]
            for name, g, w in zip(names, got, want):
                check(g.shape == w.shape, f"chain {name} shape {g.shape} != {w.shape}")
                r, d = rel_err(g, w)
                tol = 1e-4 if (noise or name in ("xsum", "zsum")) else 1e-5
                print(f"  chain {shape} noise={noise} b={'yes' if bb is not None else 'None'} "
                      f"z={'yes' if zz is not None else 'None'} {name}: rel {r:.2e} abs {d:.2e} (tol {tol:g})")
                check(r <= tol, f"chain kernel {name} disagrees with its twin: {r:.3e} > {tol:g}")
                if main:
                    worst = max(worst, d)
        # #1 equals #5 (the same body on another plan) bit for bit
        for bb, zz in ((b, None), (None, z)):
            kw = dict(z=zz, with_xsum=True, with_zsum=zz is not None)
            one = mg_sweep.fused_chain_down_fd(x, bb, *args, **kw)
            five = mg_sweep.fused_chain_down_2d_staged(x, bb, *args, **kw)
            check(torch.equal(one[0], five[0]) and torch.equal(one[1], five[1]),
                  f"#1 and #5 differ at {shape}")
        plan = mg_sweep.chain_fd_plan(shape, with_z=True)
        print(f"  #1 at {shape}: == #5 bit for bit (xpy, rc); plan {plan.items} work items of "
              f"{plan.tile} (+{plan.halo} planes each side), {'TMA' if plan.tma else 'cp.async'}")
        if main:
            kw = dict(z=z, with_xsum=True, with_zsum=True)
            ms = queued_ms(torch, lambda: mg_sweep.fused_chain_down_fd(x, None, *args, **kw), 20)
            plain, _ = device_ms(
                torch, lambda: mg_sweep.fused_chain_down_fd_reference(x, None, *args, **kw), 5
            )
            n = x.numel()
            bms, by = bound(march_bytes(n, True, False, True, plan.items), FLOPS_CHAIN * n)
            rec["chain"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bms,
                                bound_by=by, library_ms=None)
            launch_report(f"#1 at {shape} (x, z)", "chain_march", (1, 0, 1), plan)
            print(f"  chain kernel at {shape} (b=None, z, sums, noise): {ms:.4f} ms (queued), "
                  f"twin {plain:.4f} ms, bound {bms:.4f} ms ({by})")
        del x, b, z

    # tail kernel: the main path's levels 1..4, plus the small test shapes
    shapes = tuple(tuple(o.grid_shape) for o in main_smp.ops[1:])
    params = []
    for s in main_smp.smoothers[1:]:
        params += [s.omega, s.fd_params[0], s.fd_params[1]]
    small_shapes = ((32, 32, 64), (16, 16, 32), (8, 8, 16), (4, 4, 8))
    small_params = [1.0, 1.0, 961.0, 1.0, 8.0, 3844.0, 1.0, 64.0, 15376.0]
    from parmgmc_tpu_torch import kernels

    for shp, prm, main in ((shapes, params, True), (small_shapes, small_params, False)):
        bl = randn(*shp[0])
        worst = 0.0
        for noise in (False, True):
            for color0 in (0, 1):
                kernels.reset_launch_counts()
                ys, rhs = mg_tail.fused_tail_down(bl, prm, 99, 5, color0, shp, with_noise=noise)
                launched = kernels.launch_counts()["tail_down"]
                check(launched == 1, f"a tail call over {len(shp) - 1} levels launched {launched} kernels")
                ys_r, rhs_r = mg_tail.tail_down_reference(bl, prm, 99, 5, color0, shp, with_noise=noise)
                torch.cuda.synchronize()
                tol = 1e-4 if noise else 1e-5
                for li, (g, w) in enumerate(zip([*ys, rhs], [*ys_r, rhs_r])):
                    r, d = rel_err(g, w)
                    check(r <= tol, f"tail kernel output {li} disagrees with its twin: {r:.3e} > {tol:g}")
                    if main:
                        worst = max(worst, d)
                print(f"  tail {shp[0]}.. noise={noise} color0={color0}: outputs agree (tol {tol:g}); "
                      f"{launched} launch a call over {len(shp) - 1} levels")
        if main:
            ms = queued_ms(torch, lambda: mg_tail.fused_tail_down(bl, prm, 99, 5, 0, shp), 20)
            plain, _ = device_ms(torch, lambda: mg_tail.tail_down_reference(bl, prm, 99, 5, 0, shp), 5)
            sizes = [math.prod(sh) for sh in shp[:-1]]
            bms, by = bound(sum(4 * (2 * m + m // 8) for m in sizes), FLOPS_TAIL * sum(sizes))
            rec["tail"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bms,
                               bound_by=by, library_ms=None)
            occ = kernels.occupancy("tail_grid")
            slots = occ["blocks_per_sm"] * occ["sms"]
            print(f"  #2 over {len(shp) - 1} levels: one cooperative launch of "
                  f"{min(slots, mg_tail.tail_blocks(shp))} blocks ({occ['blocks_per_sm']} an SM x "
                  f"{occ['sms']} SMs; the largest phase has work for {mg_tail.tail_blocks(shp)})")
            # #3 over the same levels (the V(1,0) cycle's other route, the
            # shape rule patched): data for the routing rules, not a check
            t3 = 0.0
            cur = bl
            for sm, sh in zip(main_smp.smoothers[1:], shp[:-1]):
                a3 = (sm._coeff6(), sm.fd_params[0], sm.fd_params[1], sm.omega, 99, 5)
                t3 += queued_ms(torch, lambda c=cur, a3=a3: mg_sweep.fused_zero_gibbs_restrict_fd(c, *a3), 20)
                cur = randn(*(d // 2 for d in sh))
            print(f"  tail kernel over {len(shp) - 1} levels from {shp[0]}: {ms:.4f} ms (queued; one launch), "
                  f"#3 over the same levels {t3:.4f} ms ({len(shp) - 1} launches), twin {plain:.4f} ms, "
                  f"bound {bms:.4f} ms ({by})")

    # the full sweep in FD mode (#7) and with the diagonal streamed (#6): at
    # every smoothed level of the V(2,2) path with that level's coefficients
    # (256^3 first), plus a small ragged-tile shape
    from parmgmc_tpu_torch.kernels import rb_gibbs
    from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd

    cases = [(o, s.fd_params, s._coeff6(), s.omega) for o, s in zip(v22_smp.ops, v22_smp.smoothers)]
    hinv2 = 15.0**2
    cases.append((shifted_laplace_fd((16, 24, 96), 1.0, device=dev), (1.0, hinv2), [-hinv2] * 6, 1.3))
    for li, (op, (kappa2, hinv2), coeffs, omega) in enumerate(cases):
        main, shape = li == 0, tuple(op.grid_shape)
        x, b = randn(*shape), randn(*shape)
        diag = field_operator(torch, op).diag
        calls = {
            "fd": (rb_gibbs.fused_rb_gibbs_sweep_fd, rb_gibbs.fused_rb_gibbs_sweep_fd_reference,
                   (coeffs, kappa2, hinv2, omega, 1234, 77)),
            "streamed": (rb_gibbs.fused_rb_gibbs_sweep, rb_gibbs.fused_rb_gibbs_sweep_reference,
                         (diag, coeffs, omega, 1234, 77)),
        }
        for mode, (kern, twin, args) in calls.items():
            worst, rels = 0.0, {False: 0.0, True: 0.0}
            for sweep in ("forward", "backward"):
                for noise in (False, True):
                    for bb in (b, None):
                        kw = dict(sweep=sweep, with_noise=noise)
                        got, want = kern(x, bb, *args, **kw), twin(x, bb, *args, **kw)
                        torch.cuda.synchronize()
                        check(got.shape == want.shape, f"sweep {mode} shape {got.shape} != {want.shape}")
                        r, d = rel_err(got, want)
                        tol = 1e-4 if noise else 1e-5
                        check(r <= tol, f"sweep kernel ({mode}, {sweep}, noise={noise}, "
                                        f"b={'yes' if bb is not None else 'None'}) disagrees with "
                                        f"its twin: {r:.3e} > {tol:g}")
                        rels[noise] = max(rels[noise], r)
                        worst = max(worst, d)
            print(f"  sweep {mode} {shape} omega {omega:g} kappa2 {kappa2:g} hinv2 {hinv2:g} "
                  f"forward/backward, b given/None: worst rel "
                  f"{rels[False]:.2e} noise off (tol 1e-05), {rels[True]:.2e} noise on (tol 0.0001)")
            if mode == "fd":
                # every level's V(2,2) call (b, noise), on the full sweep's plan
                p = rb_gibbs.full_sweep_plan(shape)
                t = queued_ms(torch, lambda: kern(x, b, *args), 20)
                print(f"  #7 at {shape} (b, noise): {t:.4f} ms; plan: {p.items} work items of {p.tile} "
                      f"(+{p.halo} planes each side), {'TMA' if p.tma else 'cp.async'}")
            if main:
                # what the main paths run: V(2,2) level 0 sweeps with b (FD);
                # the streamed Gibbs chain on the prior (b = None)
                bb = b if mode == "fd" else None
                ms, _ = device_ms(torch, lambda: kern(x, bb, *args), 50)
                plain, _ = device_ms(torch, lambda: twin(x, bb, *args), 5)
                n = x.numel()
                bms, by = bound(4 * 3 * n, FLOPS_SWEEP[mode] * n)
                rec[f"sweep_{mode}"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bms,
                                            bound_by=by, library_ms=None)
                print(f"  sweep {mode} kernel at {shape} (b={'yes' if bb is not None else 'None'}, "
                      f"noise): {ms:.4f} ms, twin {plain:.4f} ms, bound {bms:.4f} ms ({by})")
        del x, b, diag
    return rec


def queued_ms(torch, fn, n):
    """Device ms per call of fn over n calls after one warm-up, the calls
    queued behind a sleeping kernel so that they run back to back (CUDA
    events around a run of small kernels otherwise time the host's launch
    gaps)."""
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


def event_ms(torch, fn, n):
    """Device ms per call of fn over n calls after one warm-up, from CUDA
    events around the run.  For the patch kernels: torch.profiler drops
    some records of cooperative launches on this card, so its device
    times and launch counts under-read them."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def chain_moments(torch, label, smp, b, n, burnin=200):
    """(mean, var, n) of smp's chain over n steps after burn-in, timed."""
    from parmgmc_tpu_torch.chain import init_chain, sample_moments

    t0 = time.perf_counter()
    _, mean, var = sample_moments(smp, init_chain(smp, 7), b, n, burnin=burnin)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"  {label}: {n} steps in {dt:.1f} s ({dt / (n + burnin) * 1e3:.4f} ms/step)")
    return mean.double(), var.double(), n


def moments_check(torch, label, kern, plain, rgate, zgate=10.0):
    """Per-cell mean z-scores (two-sample SE) and variance gaps of the
    kernel chain's moments against the plain chain's."""
    (mk, vk, nk), (mp, vp, n_p) = kern, plain
    se = torch.sqrt(vk / nk + vp / n_p)
    z = (mk - mp).abs() / se.clamp(min=1e-12)
    rvar = (vk - vp).abs() / vp.clamp(min=1e-12)
    zmax, zmean, rmax = z.max().item(), z.mean().item(), rvar.max().item()
    print(f"  {label}: max |z| {zmax:.3f} (gate {zgate:g}), mean |z| {zmean:.3f} (gate 2.5), "
          f"max relative var gap {rmax:.4f} (gate {rgate})")
    check(zmax < zgate and zmean < 2.5 and rmax < rgate,
          f"{label}: kernel chain moments drifted from the plain chain")


def moments_gate(torch, label, smp, b, n):
    """The keyed chain of smp against its explicit-noise chain: n steps
    after 200 burn-in each, per-cell mean z-scores and variance gaps."""
    from parmgmc_tpu_torch.chain import ExplicitNoise

    kern = chain_moments(torch, f"{label} kernel chain", smp, b, n)
    plain = chain_moments(torch, f"{label} plain chain", ExplicitNoise(smp), b, n)
    moments_check(torch, label, kern, plain, 0.2)
    return kern, plain


def phase_moments(torch, dev):
    from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    op = shifted_laplace_fd((16, 16, 128), 1.0, device=dev)
    b = torch.full(op.grid_shape, 50.0, device=dev)
    smp = MGMCSampler.create(op, n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate")
    moments_gate(torch, "V(1,0)", smp, b, N_MOMENTS)
    return smp, b


def phase_deferred(torch, smp, b, main_smp):
    from parmgmc_tpu_torch.chain import init_chain, sample_chain, sample_chain_deferred

    for tag, s, bb in (("16x16x128 b=50", smp, b), (f"{N_MAIN}^3 b=None", main_smp, None)):
        st = init_chain(s, 5)
        sa, qa = sample_chain(s, st, bb, 8, extract=torch.mean)
        sb, qb = sample_chain_deferred(s, st, bb, 8)
        check(torch.equal(sa.x, sb.x), f"deferred chain diverged bitwise from sample_chain ({tag})")
        dq = (qa - qb).abs().max().item()
        print(f"  {tag}: states bit-identical over 8 steps; max |QOI diff| {dq:.3e}")
        check(dq <= 1e-5 * max(qa.abs().max().item(), 1e-3), "deferred QOI disagrees")


def phase_main(torch, dev, smp, n=N_MAIN, n_time=N_TIME, n_iact=N_IACT, want=None, twin=True):
    """The prior chain of smp on an n^3 grid through sample_chain_deferred:
    ms/cycle, tau and ESS/sec, the exact law of the QOI, the launches (each
    of the chain and tail kernels > 0, or exactly want(steps) when given),
    the device time of a step by kernel and, with ``twin``, the same keyed
    cycle with the twins in place of the kernels."""
    from parmgmc_tpu_torch import kernels, replay
    from parmgmc_tpu_torch.chain import init_chain, sample_chain_deferred
    from parmgmc_tpu_torch.diagnostics.iact import iact
    from parmgmc_tpu_torch.kernels import mg_sweep, mg_tail

    st = init_chain(smp, 0)
    st, _ = sample_chain_deferred(smp, st, None, 64 if twin else 16)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    st, _ = sample_chain_deferred(smp, st, None, n_time)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_time
    st, q = sample_chain_deferred(smp, st, None, n_iact)
    q = q.double().cpu()
    torch.cuda.synchronize()
    counts = kernels.launch_counts(plain=False)
    print(f"  launches during the main path ({n_time + n_iact} steps): {counts}")
    if want is None:
        check(counts["chain_down"] > 0 and counts["tail_down"] > 0,
              f"the main path did not run both kernels: {counts}")
    else:
        expect = want(n_time + n_iact)
        check(counts == expect, f"the {n}^3 path launched {counts}, expected {expect}")

    x = st.x
    check(tuple(x.shape) == (n,) * 3 and bool(torch.isfinite(x).all()),
          "final state has the wrong shape or non-finite values")
    check(bool(torch.isfinite(q).all()) and q.shape == (n_iact,), "QOI chain not finite")
    # the last QOI is the mean of the materialised final state
    dq = abs(q[-1].item() - x.double().mean().item())
    check(dq < 1e-6, f"last QOI {q[-1].item():.6e} != mean of final state ({dq:.2e})")
    # prior law of the QOI: A 1 = kappa^2 1, so mean(x) ~ N(0, 1/(kappa^2 N))
    npts = n**3
    var_ratio = q.var().item() * npts
    zmean = q.mean().item() * math.sqrt(npts * n_iact)
    tau, valid = iact(q)
    tau_c = max(tau, 1.0)
    print(f"  QOI: var * N = {var_ratio:.4f} (exact 1), mean / SE = {zmean:.3f}, "
          f"tau {tau:.4f} (valid {valid})")
    check(0.8 < var_ratio < 1.25, "QOI variance is off the prior's exact value")
    check(abs(zmean) < 5.0 * math.sqrt(tau_c), "QOI mean is off zero")
    ess = 1.0 / (tau_c * dt)
    print(f"  {n}^3 path: {dt * 1e3:.4f} ms/cycle, tau {tau:.4f}, ESS/sec {ess:.2f}")

    # where the device time of a step goes (a separate, profiled window
    # of 32 steps: the chain's one-off carry set-up and final
    # materialisation spread over them)
    holder, n_win = [st], 32
    del st, x

    def window():
        holder[0], _ = sample_chain_deferred(smp, holder[0], None, n_win)

    busy, per = device_ms(torch, window, 1)
    busy, per = busy / n_win, {k: v / n_win for k, v in per.items()}
    for name, t in sorted(per.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  device per step: {t:.4f} ms  {name}")
    # the profiler drops records of cooperative launches (#2): the step's
    # device time is also read from windows queued behind a sleeping kernel
    queued = queued_ms(torch, window, 2) / n_win
    idle = max(0.0, 1.0 - queued / (dt * 1e3))
    print(f"  device busy {busy:.4f} ms/step (profiler), {queued:.4f} ms/step back to back (queued), "
          f"of {dt * 1e3:.4f} ms/cycle: idle share ~{idle:.3f}")
    if not twin:
        return counts

    # the same keyed cycle with the plain twins in place of the kernels (the
    # eager step: a replayed graph holds the kernels)
    st = holder[0]
    with mock.patch.object(mg_sweep, "fused_chain_down_fd", mg_sweep.fused_chain_down_fd_reference), \
            mock.patch.object(mg_tail, "fused_tail_down", mg_tail.tail_down_reference), \
            mock.patch.object(replay, "graphs_for", lambda *a: None):
        st2, _ = sample_chain_deferred(smp, st, None, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_chain_deferred(smp, st2, None, 8)
        torch.cuda.synchronize()
        dt_twin = (time.perf_counter() - t0) / 8
    print(f"  twin path: {dt_twin * 1e3:.4f} ms/cycle")
    return counts


def moments_problems(torch, dev, b):
    """The problems of phase 7: {label: (sampler, b, steps)}."""
    from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
    from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    op = shifted_laplace_fd((16, 16, 128), 1.0, device=dev)
    probs = {"V(2,2)": (MGMCSampler.create(op, n_pre=2, n_post=2, coarsest_size=128,
                                                coarsening="aggregate"), b, N_MOMENTS_V22)}
    # Gibbs: kappa^2 = 900 against h^-2 = 225, so a sweep contracts by ~0.4
    op = shifted_laplace_fd((16, 16, 32), 30.0, device=dev)
    bg = torch.full(op.grid_shape, 50.0, device=dev)
    for label, o, sweep in (("Gibbs FD symmetric", op, "symmetric"),
                            ("Gibbs streamed forward", field_operator(torch, op), "forward")):
        probs[label] = (GibbsSampler.create(o, sweep=sweep), bg, N_MOMENTS_GIBBS)
    return probs


def phase_moments_general(torch, dev, b):
    """The phase-7 problems' keyed chains against their explicit-noise
    chains; returns {label: (kernel moments, plain moments)}."""
    probs = moments_problems(torch, dev, b)
    smp = probs["V(2,2)"][0]
    check(not smp.deferred_eligible(), "V(2,2) must run the general keyed cycle")
    for label in ("Gibbs FD symmetric", "Gibbs streamed forward"):
        g = probs[label][0]
        check(g.has_kernel and (g.fd_params is None) == ("streamed" in label),
              f"{label}: the keyed step does not take the expected kernel")
    return {label: moments_gate(torch, label, smp, bb, n) for label, (smp, bb, n) in probs.items()}


def phase_v22(torch, smp, per_step, n_time=N_TIME, n_iact=N_IACT, n_warm=32, twin=True, plain_levels=0,
              n_win=16):
    """The V(2,2) prior chain of smp through sample_chain with the mean as
    QOI: ms/cycle over n_time steps, tau and ESS/sec from n_iact steps,
    var(QOI) N, exactly per_step[counter] launches a step of each counter
    and no other kernel (``plain_levels`` smoothed levels sweep in plain
    torch), the device time of a step by kernel over a profiled window of
    ``n_win`` steps, and, with ``twin``, the cycle with the FD sweep's
    twin in place of the kernels (eager: a replayed graph holds the
    kernels).  Every timed step is a replay of the step the warm-up
    captured, where no level sweeps in plain torch.  Returns (counts,
    final chain state)."""
    from parmgmc_tpu_torch import kernels, replay
    from parmgmc_tpu_torch.chain import init_chain, sample_chain
    from parmgmc_tpu_torch.diagnostics.iact import iact
    from parmgmc_tpu_torch.kernels import rb_gibbs
    from parmgmc_tpu_torch.kernels.galerkin_sweep import LAUNCHES
    from parmgmc_tpu_torch.samplers import gibbs

    sweeps = (smp.n_pre + smp.n_post) * (smp.n_levels - 1 - plain_levels)
    per_sweep = {"galerkin_sweep": LAUNCHES}  # launches a sweep where not one
    check(sum(v // per_sweep.get(k, 1) for k, v in per_step.items()
              if k not in ("residual_restrict", "prolong_add")) == sweeps
          and not smp.deferred_eligible(),
          f"V(2,2) over {smp.n_levels} levels does not run {per_step} sweeps a step")
    shape = tuple(smp.grid_shape)
    st = init_chain(smp, 0)
    st, _ = sample_chain(smp, st, None, n_warm, extract=torch.mean)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    st, _ = sample_chain(smp, st, None, n_time, extract=torch.mean)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_time
    st, q = sample_chain(smp, st, None, n_iact, extract=torch.mean)
    q = q.double().cpu()
    torch.cuda.synchronize()
    counts = kernels.launch_counts(plain=False)
    steps = n_time + n_iact
    print(f"  launches during the V(2,2) path: {counts} over {steps} steps")
    expect = dict.fromkeys(counts, 0)
    expect.update({k: v * steps for k, v in per_step.items()})
    # every timed step is a replay of the step the warm-up captured
    expect["chain_step_graph"] = steps if plain_levels == 0 else 0
    check(counts == expect, f"expected exactly {per_step} sweep launches a step and no other kernel: {counts}")

    x = st.x
    check(tuple(x.shape) == shape and bool(torch.isfinite(x).all()),
          "final state has the wrong shape or non-finite values")
    check(bool(torch.isfinite(q).all()) and q.shape == (n_iact,), "QOI chain not finite")
    npts = math.prod(shape)
    var_ratio = q.var().item() * npts
    zmean = q.mean().item() * math.sqrt(npts * n_iact)
    tau, valid = iact(q)
    tau_c = max(tau, 1.0)
    print(f"  QOI over {n_iact} steps: var * N = {var_ratio:.4f} (exact 1), mean / SE = {zmean:.3f}, "
          f"tau {tau:.4f} (valid {valid})")
    check(0.8 < var_ratio < 1.25, "QOI variance is off the prior's exact value")
    check(abs(zmean) < 5.0 * math.sqrt(tau_c), "QOI mean is off zero")
    ess = 1.0 / (tau_c * dt)
    print(f"  V(2,2) path {shape}: {dt * 1e3:.4f} ms/cycle, tau {tau:.4f}, ESS/sec {ess:.2f}")

    holder = [st]

    def window():
        holder[0], _ = sample_chain(smp, holder[0], None, n_win, extract=torch.mean)

    busy, per = device_ms(torch, window, 1)
    busy, per = busy / n_win, {k: v / n_win for k, v in per.items()}
    for name, t in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  device per step: {t:.4f} ms  {name}")
    idle = max(0.0, 1.0 - busy / (dt * 1e3))
    print(f"  device busy {busy:.4f} ms/step of {dt * 1e3:.4f} ms/cycle: idle share ~{idle:.3f}")
    if not twin:
        return counts, holder[0]

    st = holder[0]
    with mock.patch.object(gibbs, "fused_rb_gibbs_sweep_fd", rb_gibbs.fused_rb_gibbs_sweep_fd_reference), \
            mock.patch.object(replay, "graphs_for", lambda *a: None):
        st2, _ = sample_chain(smp, st, None, 1, extract=torch.mean)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_chain(smp, st2, None, 3, extract=torch.mean)
        torch.cuda.synchronize()
        dt_twin = (time.perf_counter() - t0) / 3
    print(f"  twin path: {dt_twin * 1e3:.4f} ms/cycle")
    return counts, holder[0]


def phase_gibbs(torch, op, cases, n_steps):
    """Keyed Gibbs chains on op (b = None) for each (mode, sweep, counter)
    of ``cases`` (mode "FD" runs op, "streamed" op with its diagonal times
    smooth_field): wall ms per sweep over n_steps steps and exactly one
    launch of ``counter`` a half-sweep, no other kernel."""
    from parmgmc_tpu_torch import kernels
    from parmgmc_tpu_torch.chain import init_chain, sample_chain
    from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler

    shape = tuple(op.grid_shape)
    ops = {"FD": op, "streamed": field_operator(torch, op)}
    kernels.reset_launch_counts()
    want = kernels.launch_counts(plain=False)
    for mode, sweep, counter in cases:
        smp = GibbsSampler.create(ops[mode], sweep=sweep)
        halves = 2 if sweep == "symmetric" else 1
        st, _ = sample_chain(smp, init_chain(smp, 1), None, 4, extract=torch.mean)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, q = sample_chain(smp, st, None, n_steps, extract=torch.mean)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / (n_steps * halves)
        want[counter] += (4 + n_steps) * halves
        check(bool(torch.isfinite(st.x).all()) and bool(torch.isfinite(q).all()),
              f"Gibbs {mode} {sweep} chain is not finite")
        print(f"  Gibbs {mode} {sweep} at {shape}: {dt * 1e3:.4f} ms/sweep ({n_steps} steps, "
              f"{halves} {counter} launch(es) a step)")
    counts = kernels.launch_counts(plain=False)
    print(f"  launches during the Gibbs chains: {counts}")
    check(counts == want, f"Gibbs chains launched {counts}, expected {want}")
    return counts


def phase_patch_kernels(torch, dev, smps):
    """#10 and #11 against the twin (noise on and off, b given and None)
    on the main paths' squared operators and a small odd shape, and bit
    for bit against each other; device times of the paths' calls."""
    from parmgmc_tpu_torch.kernels import patch_sweep as ps

    rec = {}
    gen = torch.Generator(device=dev).manual_seed(321)
    cases = [(tuple(s.grid_shape), s.sq_fd_params) for s in smps]
    cases.append(((11, 12, 13), (1.69, 100.0)))  # extents not multiples of 5

    def whole(*a, **kw):  # #10 at any size: the size rule patched
        with mock.patch.object(ps, "patch_sweep_resident", lambda shape, with_b: True):
            return ps.fused_patch_sweep_sqfd(*a, **kw)

    for shape, (k2, h2) in cases:
        x = torch.randn(*shape, generator=gen, device=dev)
        b = torch.randn(*shape, generator=gen, device=dev)
        worst, rels = 0.0, []
        for noise in (False, True):
            for bb in (b, None):
                args, kw = (x, bb, k2, h2, 1234, 77), dict(with_noise=noise)
                g10 = whole(*args, **kw)
                g11 = ps.fused_patch_sweep_sqfd_streamed(*args, **kw)
                gcw = ps.fused_patch_sweep_sqfd_colourwise(*args, **kw)
                want = ps.fused_patch_sweep_sqfd_reference(*args, **kw)
                torch.cuda.synchronize()
                check(g10.shape == want.shape == g11.shape, f"patch sweep shape {g10.shape} != {want.shape}")
                check(torch.equal(g10, g11), f"#10 and #11 differ at {shape} (noise={noise}, "
                                             f"b={'yes' if bb is not None else 'None'})")
                check(torch.equal(g11, gcw), f"#11 differs from the colour-by-colour order at {shape} "
                                             f"(noise={noise}, b={'yes' if bb is not None else 'None'})")
                del gcw
                r, d = rel_err(g10, want)
                check(r <= 1e-4, f"patch sweep kernel ({shape}, noise={noise}, b="
                                 f"{'yes' if bb is not None else 'None'}) disagrees with its twin: {r:.3e} > 1e-4")
                check(bool(torch.isfinite(g10).all()), f"patch sweep at {shape} is not finite")
                rels.append(r)
                worst = max(worst, d)
        print(f"  patch {shape} kappa2 {k2:g} hinv2 {h2:g}: #10 == #11 == the colour order bit for bit; "
              f"worst rel "
              f"against the twin {max(rels):.2e} (tol 1e-4), noise on/off, b given/None")
        n = x.numel()
        bms, by = bound(4 * 2 * n, FLOPS_PATCH * n)
        routes = (("patch", whole, shape == (128,) * 3),
                  ("patch_streamed", ps.fused_patch_sweep_sqfd_streamed, shape == (256,) * 3))
        for route, fn, main in routes if shape != (11, 12, 13) else ():
            ms = event_ms(torch, lambda: fn(x, None, k2, h2, 1234, 77), 10)
            line = f"  {route} kernel at {shape} (b=None, noise): {ms:.4f} ms, bound {bms:.4f} ms ({by})"
            if main:  # the shape phase 12 runs through this route
                plain, _ = device_ms(torch, lambda: ps.fused_patch_sweep_sqfd_reference(
                    x, None, k2, h2, 1234, 77), 1)
                rec[route] = dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bms,
                                  bound_by=by, library_ms=None)
                line += f", twin {plain:.4f} ms"
            print(line)
        del x, b
    return rec


def phase_patch_moments(torch, dev):
    from parmgmc_tpu_torch import kernels
    from parmgmc_tpu_torch.chain import ExplicitNoise
    from parmgmc_tpu_torch.kernels import patch_sweep as ps
    from parmgmc_tpu_torch.models.problems import squared_shifted_laplace_fd
    from parmgmc_tpu_torch.samplers.patch_gibbs import PatchGibbsSampler

    op = squared_shifted_laplace_fd((16, 10, 128), 40.0, device=dev)
    b = torch.full(op.grid_shape, 5.0, device=dev)
    smp = PatchGibbsSampler.create(op)
    check(smp.sq_fd_params is not None, "the patch sampler did not detect the squared FD operator")
    print(f"  detected (kappa2, hinv2) = {smp.sq_fd_params} (exact 1600, 225)")
    plain = chain_moments(torch, "patch plain chain", ExplicitNoise(smp), b, N_PATCH_PLAIN, burnin=50)
    for route, resident in (("#10", True), ("#11", False)):
        kernels.reset_launch_counts()
        with mock.patch.object(ps, "patch_sweep_resident", lambda shape, with_b: resident):
            kern = chain_moments(torch, f"patch {route} kernel chain", smp, b, N_PATCH_MOMENTS, burnin=50)
        counts = kernels.launch_counts()
        steps = N_PATCH_MOMENTS + 50
        want = {"patch_sweep": steps if resident else 0, "patch_sweep_streamed": 0 if resident else steps}
        check(all(counts[k] == v for k, v in want.items()), f"patch {route} chain launched {counts}")
        moments_check(torch, f"patch {route}", kern, plain, 0.35)


def phase_patch_path(torch, smps):
    from parmgmc_tpu_torch import kernels
    from parmgmc_tpu_torch.chain import init_chain, sample_chain
    from parmgmc_tpu_torch.kernels import patch_sweep as ps

    counts = {}
    for smp in smps:
        shape = tuple(smp.grid_shape)
        route = "patch_sweep" if shape == (128,) * 3 else "patch_sweep_streamed"
        st, _ = sample_chain(smp, init_chain(smp, 0), None, 4, extract=torch.mean)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st, q = sample_chain(smp, st, None, N_PATCH_TIME, extract=torch.mean)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / N_PATCH_TIME
        c = kernels.launch_counts(plain=False)
        print(f"  {shape}: launches {c} over {N_PATCH_TIME} sweeps")
        check(c[route] == N_PATCH_TIME and sum(c.values()) == N_PATCH_TIME,
              f"the {shape} patch chain should make exactly one {route} call a sweep: {c}")
        counts[route] = c[route]
        check(tuple(st.x.shape) == shape and bool(torch.isfinite(st.x).all())
              and bool(torch.isfinite(q).all()) and q.shape == (N_PATCH_TIME,),
              f"the {shape} patch chain is not finite")
        # device time of a sweep: CUDA events around each step and its QOI
        # (one C call enqueues the copy and the kernel launches of a step)
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(N_PATCH_TIME)]
        key, x = st.key, st.x
        for e0, e1 in evs:
            e0.record()
            key, x = smp.step(key, x, None)
            torch.mean(x)
            e1.record()
        torch.cuda.synchronize()
        busy = sum(e0.elapsed_time(e1) for e0, e1 in evs) / N_PATCH_TIME
        # host time of a step: the Python and C call up to its return, the
        # card idle at the start (median of 8)
        host = []
        for _ in range(8):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            key, x = smp.step(key, x, None)
            host.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        host_ms = sorted(host)[4] * 1e3
        per_call = 1 if route == "patch_sweep" else sum(
            1 for ph in ps.patch_schedule(shape).phases if ph.lines)
        idle = max(0.0, 1.0 - busy / (dt * 1e3))
        print(f"  patch path {shape}: {dt * 1e3:.4f} ms/sweep wall ({N_PATCH_TIME} sweeps), device "
              f"{busy:.4f} ms/sweep, idle share ~{idle:.3f}, host {host_ms:.4f} ms/sweep to "
              f"enqueue; one {route} call a sweep, "
              f"{per_call} kernel launch(es) each; last QOI {q[-1].item():.4e}")
    return counts


def launch_report(label, entry, flags, plan):
    """Print a marching launch's geometry (kernels/_march.py) and what the
    card gives it: blocks an SM, shared bytes, waves of block slots."""
    from parmgmc_tpu_torch import kernels

    occ = kernels.occupancy(entry, *flags)
    slots = occ["blocks_per_sm"] * occ["sms"]
    print(f"  {label}: {plan.items} work items of {plan.tile} (+{plan.halo} planes each side), "
          f"{'TMA' if plan.tma else 'cp.async'}; {occ['blocks_per_sm']} blocks an SM x {occ['sms']} "
          f"SMs, {occ['smem_bytes']} B shared each: {plan.items / slots:.2f} waves")
    check(occ["blocks_per_sm"] > 0, f"{label}: the launch fits no block on an SM")


def march_bytes(n, with_x, with_b, with_z, nblk=0):
    """Bytes the chain function must move on an n-point grid: each input
    read once, each output (xpy or y, rc, partial sums) written once."""
    return 4 * (n * (with_x + with_b + 1) + n // 8 * (1 + with_z) + 2 * nblk)


def phase_march_kernels(torch, dev, big_smp):
    """#5 (staged), #4 (windowed) and #3 (from zero) against their twins
    and bit for bit against each other; on the full 768^3 grid #5 and #4
    against #1; device times (CUDA events) of #5, #4 and #1 at 768^3, #3
    at each level and the tail kernel forced over levels 1 .. L-2."""
    from parmgmc_tpu_torch.kernels import _twin, mg_tail
    from parmgmc_tpu_torch.kernels import mg_sweep as ms

    rec = {}
    gen = torch.Generator(device=dev).manual_seed(456)
    randn = lambda *sh: torch.randn(*sh, generator=gen, device=dev)
    pairs = ((ms.fused_chain_down_2d_staged, ms.fused_chain_down_2d_staged_reference),
             (ms.fused_chain_down_2d, ms.fused_chain_down_2d_reference))
    worst = 0.0
    for shape in ((32, N_BIG, N_BIG), RAGGED_BIG, RAGGED_ODD):
        x, b, z = randn(*shape), randn(*shape), randn(*(d // 2 for d in shape))
        hinv2 = float((shape[0] - 1) ** 2)
        args = ([-hinv2] * 6, 1.0, hinv2, 1.0, 1234, 77)
        rels = {False: 0.0, True: 0.0}
        for sweep in ("forward", "backward"):
            for noise in (False, True):
                for bb, zz in ((b, None), (None, z)):
                    kw = dict(sweep=sweep, with_noise=noise, z=zz, with_xsum=True,
                              with_zsum=zz is not None)
                    outs = []
                    for kern, twin in pairs:
                        got, want = kern(x, bb, *args, **kw), twin(x, bb, *args, **kw)
                        torch.cuda.synchronize()
                        for name, g, w in zip(("xpy", "rc", "xsum", "zsum"), got, want):
                            check(g.shape == w.shape, f"{kern.__name__} {name} shape {g.shape} != {w.shape}")
                            r, d = rel_err(g, w)
                            tol = 1e-4 if (noise or name in ("xsum", "zsum")) else 1e-5
                            check(r <= tol, f"{kern.__name__} {name} ({shape}, {sweep}, noise={noise}, "
                                            f"b={'yes' if bb is not None else 'None'}) disagrees with its "
                                            f"twin: {r:.3e} > {tol:g}")
                            rels[noise] = max(rels[noise], r)
                            if shape[0] == 32:
                                worst = max(worst, d)
                        outs.append(got)
                    check(torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1]),
                          f"#4 and #5 differ at {shape} ({sweep}, noise={noise})")
            # #3(b) is #5(x = 0, b) bit for bit
            y, rc = ms.fused_zero_gibbs_restrict_fd(b, *args, sweep=sweep)
            y5, rc5 = ms.fused_chain_down_2d_staged(torch.zeros_like(b), b, *args, sweep=sweep)
            check(torch.equal(y, y5) and torch.equal(rc, rc5), f"#3 is not #5 from zero at {shape}")
        if shape == RAGGED_ODD:
            launch_report(f"#5, #4 at {shape} (x, z)", "chain_march", (1, 0, 1), ms.chain_plan(shape, with_z=True))
        print(f"  #5 and #4 at {shape}: forward/backward, noise on/off, b given / None with z and sums: "
              f"worst rel {rels[False]:.2e} noise off (tol 1e-05), {rels[True]:.2e} noise on (tol 0.0001); "
              f"#4 == #5 bit for bit, #3(b) == #5(0, b) bit for bit")
        del x, b, z

    # #3 at every smoothed level below 0 of the 768^3 hierarchy, and (8, 10, 128)
    cases = [(tuple(o.grid_shape), sm) for o, sm in zip(big_smp.ops[1:-1], big_smp.smoothers[1:])]
    cases.append(((8, 10, 128), None))
    ms3, plain3, bytes3, flops3, worst3 = 0.0, 0.0, 0, 0, 0.0
    for shape, sm in cases:
        bl = randn(*shape)
        if sm is None:
            args = ([-49.0] * 6, 1.0, 49.0, 1.3, 99, 5)
        else:
            args = (sm._coeff6(), sm.fd_params[0], sm.fd_params[1], sm.omega, 99, 5)
        rels = []
        for sweep in ("forward", "backward"):
            for noise in (False, True):
                kw = dict(sweep=sweep, with_noise=noise)
                got = ms.fused_zero_gibbs_restrict_fd(bl, *args, **kw)
                want = ms.fused_zero_gibbs_restrict_fd_reference(bl, *args, **kw)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    r, d = rel_err(g, w)
                    check(r <= (1e-4 if noise else 1e-5), f"#3 at {shape} ({sweep}, noise={noise}) "
                                                          f"disagrees with its twin: {r:.3e}")
                    rels.append(r)
                    if sm is not None:
                        worst3 = max(worst3, d)
                y5, rc5 = ms.fused_chain_down_2d_staged(torch.zeros_like(bl), bl, *args, **kw)
                check(torch.equal(got[0], y5) and torch.equal(got[1], rc5), f"#3 is not #5 from zero at {shape}")
        line = f"  #3 at {shape}: worst rel {max(rels):.2e} against the twin; == #5(0, b) bit for bit"
        if sm is not None:
            launch_report(f"#3 at {shape} (b)", "chain_march", (0, 1, 0), ms.chain_plan(shape))
            t = event_ms(torch, lambda: ms.fused_zero_gibbs_restrict_fd(bl, *args), 20)
            tp = event_ms(torch, lambda: ms.fused_zero_gibbs_restrict_fd_reference(bl, *args), 2)
            npts = bl.numel()
            ms3, plain3 = ms3 + t, plain3 + tp
            bytes3 += march_bytes(npts, False, True, False)
            flops3 += FLOPS_TAIL * npts
            line += f"; {t:.4f} ms (twin {tp:.4f} ms)"
        print(line)
        del bl
    bms, by = bound(bytes3, flops3)
    rec["zero_restrict"] = dict(max_abs_err=worst3, ms=ms3, plain_ms=plain3, bound_ms=bms, bound_by=by,
                                library_ms=None)
    print(f"  #3 over levels 1..{len(cases) - 1} (one step's launches): {ms3:.4f} ms, bound {bms:.4f} ms ({by})")

    # the tail kernel forced over the same levels
    shp = tuple(tuple(o.grid_shape) for o in big_smp.ops[1:])
    prm = []
    for sm in big_smp.smoothers[1:]:
        prm += [sm.omega, sm.fd_params[0], sm.fd_params[1]]
    bl = randn(*shp[0])
    t = event_ms(torch, lambda: mg_tail.fused_tail_down(bl, prm, 99, 5, 0, shp), 20)
    print(f"  tail kernel forced over levels {shp[0]}..{shp[-2]}: {t:.4f} ms (#3 over the same levels {ms3:.4f} ms)")
    del bl

    # the full 768^3 grid, the main path's call (b = None, z, sums, noise):
    # #5 and #4 against the twin at phase 3's tolerances, and against #1;
    # device times of the three kernels and of the twin
    shape = (N_BIG,) * 3
    x, z = randn(*shape), randn(*(d // 2 for d in shape))
    s0 = big_smp.smoothers[0]
    args = (s0._coeff6(), s0.fd_params[0], s0.fd_params[1], s0.omega, 1234, 77)
    kw = dict(z=z, with_xsum=True, with_zsum=True)
    want = ms.fused_chain_down_2d_staged_reference(x, None, *args, **kw)
    plain = event_ms(torch, lambda: ms.fused_chain_down_2d_staged_reference(x, None, *args, **kw), 1)
    out5 = ms.fused_chain_down_2d_staged(x, None, *args, **kw)
    torch.cuda.synchronize()
    errs = []
    for name, g, w in zip(("xpy", "rc", "xsum", "zsum"), out5, want):
        check(g.shape == w.shape, f"#5 {name} shape {g.shape} != {w.shape} at 768^3")
        r, d = rel_err(g, w)
        errs.append(d)
        print(f"  768^3 #5 against its twin {name}: rel {r:.2e} abs {d:.2e} (tol 1e-4)")
        check(r <= 1e-4, f"#5 disagrees with its twin at 768^3 in {name}: {r:.3e}")
    # #4's twin is #5's with partial sums per window: the same xpy, re-tiled
    # (both launch in the geometry of chain_plan: the same tiles)
    tile = ms.chain_plan(shape).tile
    want4 = (_twin.tile_sums(want[0], tile), _twin.tile_sums(z, tuple(t // 2 for t in tile)))
    scales = (want[0].double().abs().sum().item(), z.double().abs().sum().item())
    del want
    out4 = ms.fused_chain_down_2d(x, None, *args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(out5[0], out4[0]) and torch.equal(out5[1], out4[1]), "#4 and #5 differ at 768^3")
    for name, g, w in zip(("xsum", "zsum"), out4[2:], want4):
        check(g.shape == w.shape, f"#4 {name} shape {g.shape} != {w.shape} at 768^3")
        r, d = rel_err(g, w)
        errs.append(d)
        print(f"  768^3 #4 against its twin {name}: rel {r:.2e} abs {d:.2e} (tol 1e-4); xpy, rc == #5's")
        check(r <= 1e-4, f"#4 disagrees with its twin at 768^3 in {name}: {r:.3e}")
    del out4, want4
    ref = ms.fused_chain_down_fd(x, None, *args, **kw)
    torch.cuda.synchronize()
    for name, i in (("xpy", 0), ("rc", 1)):
        r, d = rel_err(out5[i], ref[i])
        print(f"  768^3 #5 (= #4) against #1 {name}: rel {r:.2e} abs {d:.2e} (tol 1e-6)")
        check(r <= 1e-6, f"#5 disagrees with #1 at 768^3 in {name}: {r:.3e}")
    for name, i, scale in (("xsum", 2, scales[0]), ("zsum", 3, scales[1])):
        d = abs(out5[i].double().sum().item() - ref[i].double().sum().item())
        check(d <= 1e-5 * scale, f"#5 {name} total disagrees with #1's at 768^3: {d:.3e}")
    del ref, out5
    n = x.numel()
    plan = ms.chain_plan(shape, with_z=True)
    launch_report("768^3 #5, #4 (x, z)", "chain_march", (1, 0, 1), plan)
    times = {}
    for key, fn in (("chain_2d_staged", ms.fused_chain_down_2d_staged), ("chain_2d", ms.fused_chain_down_2d),
                    ("chain_down", ms.fused_chain_down_fd)):
        times[key] = event_ms(torch, lambda: fn(x, None, *args, **kw), 10)
    for key in ("chain_2d_staged", "chain_2d"):
        bms, by = bound(march_bytes(n, True, False, True, plan.items), FLOPS_CHAIN * n)
        rec[key] = dict(max_abs_err=max(worst, *errs), ms=times[key], plain_ms=plain, bound_ms=bms, bound_by=by,
                        library_ms=None)
    print(f"  768^3 (b=None, z, sums, noise): #5 {times['chain_2d_staged']:.4f} ms, "
          f"#4 {times['chain_2d']:.4f} ms, #1 {times['chain_down']:.4f} ms, twin {plain:.4f} ms, "
          f"bound {rec['chain_2d_staged']['bound_ms']:.4f} ms ({rec['chain_2d_staged']['bound_by']})")
    return rec


def phase_moments_2d(torch, dev):
    """bench.py selftest2d's problem: the keyed chain (#4 at level 0, #3
    below) against the explicit-noise chain; then the deferred chain (#5)
    bit for bit against sample_chain (#4)."""
    from parmgmc_tpu_torch import kernels
    from parmgmc_tpu_torch.chain import ExplicitNoise, init_chain, sample_chain, sample_chain_deferred
    from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    op = shifted_laplace_fd((32, N_BIG, N_BIG), 1.0, device=dev)
    b = torch.full(op.grid_shape, 50.0, device=dev)
    smp = MGMCSampler.create(op, n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate")
    levels = [tuple(o.grid_shape) for o in smp.ops]
    print(f"  levels {levels}")
    check(smp._chain_level0_2d() and smp.deferred_eligible(),
          "the large-plane chain does not take the large-plane kernels")
    kernels.reset_launch_counts()
    kern = chain_moments(torch, "large-plane kernel chain", smp, b, N_MOMENTS_2D, burnin=100)
    counts = kernels.launch_counts(plain=False)
    steps = N_MOMENTS_2D + 100
    want = dict.fromkeys(counts, 0)
    want.update(chain_2d=steps, zero_restrict=(len(levels) - 2) * steps)
    print(f"  launches during the kernel chain: {counts}")
    check(counts == want, f"the large-plane chain launched {counts}, expected {want}")
    plain = chain_moments(torch, "large-plane plain chain", ExplicitNoise(smp), b, N_MOMENTS_2D, burnin=100)
    moments_check(torch, "large-plane V(1,0)", kern, plain, 0.3, zgate=14.0)

    kernels.reset_launch_counts()
    st = init_chain(smp, 5)
    sa, _ = sample_chain(smp, st, b, 8, extract=torch.mean)
    sb, _ = sample_chain_deferred(smp, st, b, 8)
    check(torch.equal(sa.x, sb.x), "the deferred chain (#5) diverged bitwise from sample_chain (#4)")
    c = kernels.launch_counts()
    check(c["chain_2d"] == 8 and c["chain_2d_staged"] == 8, f"the bitwise check ran {c}")
    print(f"  (32, {N_BIG}, {N_BIG}) b=50: sample_chain_deferred (#5) bit-identical to sample_chain (#4) "
          f"over 8 steps")
    return counts


def sweep_bytes(n, with_b, with_d):
    """Bytes a full sweep must move on an n-point grid: x, b and a streamed
    D each read once, x' written once."""
    return 4 * n * (2 + with_b + with_d)


def phase_sweep2d_kernels(torch, dev, big22):
    """#9 (staged) and #8 (windowed, FD and streamed D) against their twins
    at (32, 768, 768), the ragged plane and 768^3 (forward and backward,
    noise on and off, b given and None), bit for bit against each other and
    against the whole-plane sweeps forced at the same shape (#7 FD, #6
    streamed); device times (CUDA events) at 768^3."""
    from parmgmc_tpu_torch.kernels import _twin
    from parmgmc_tpu_torch.kernels import rb_gibbs as rg

    rec = {}
    gen = torch.Generator(device=dev).manual_seed(789)
    randn = lambda *sh: torch.randn(*sh, generator=gen, device=dev)

    def whole():  # the whole-plane route at any plane size: #7 and #6
        return mock.patch.object(rg, "_PLANE_LIMIT", 2**62)

    s0 = big22.smoothers[0]
    worst = {"staged": 0.0, "windowed": 0.0}
    for shape in ((32, N_BIG, N_BIG), RAGGED_BIG, RAGGED_ODD, (N_BIG,) * 3):
        big = shape == (N_BIG,) * 3
        x, b = randn(*shape), randn(*shape)
        if big:  # the 768^3 V(2,2) level-0 smoother's coefficients
            coeffs, fd, omega = s0._coeff6(), s0.fd_params, s0.omega
        else:
            hinv2 = float((shape[0] - 1) ** 2)
            coeffs, fd, omega = [-hinv2] * 6, (1.0, hinv2), 1.0
        diag = (_twin.fd_diag(shape, *fd, torch.float32, dev) * smooth_field(torch, shape, dev)).contiguous()
        rels = {False: 0.0, True: 0.0}
        for sweep in ("forward", "backward"):
            for noise in (False, True):
                for bb in (b, None):
                    kw = dict(sweep=sweep, with_noise=noise)
                    tag = f"{shape}, {sweep}, noise={noise}, b={'yes' if bb is not None else 'None'}"
                    tol = 1e-4 if noise else 1e-5
                    st = rg.fused_rb_gibbs_sweep_2d_staged(x, bb, coeffs, omega, 1234, 77, fd_params=fd, **kw)
                    wi = rg.fused_rb_gibbs_sweep_2d(x, bb, None, coeffs, omega, 1234, 77, fd_params=fd,
                                                    staged=False, **kw)
                    with whole():
                        r7 = rg.fused_rb_gibbs_sweep_fd(x, bb, coeffs, *fd, omega, 1234, 77, **kw)
                    torch.cuda.synchronize()
                    check(torch.equal(st, wi), f"#9 and #8 (FD) differ at {tag}")
                    d7 = (st - r7).abs().max().item()
                    check(torch.equal(st, r7), f"#9 and #7 differ at {tag}: max |diff| {d7:.3e}")
                    del wi, r7
                    want = rg.fused_rb_gibbs_sweep_2d_staged_reference(x, bb, coeffs, omega, 1234, 77,
                                                                       fd_params=fd, **kw)
                    r, d = rel_err(st, want)
                    check(r <= tol, f"#9 disagrees with its twin at {tag}: {r:.3e} > {tol:g}")
                    rels[noise] = max(rels[noise], r)
                    worst["staged"] = max(worst["staged"], d)
                    worst["windowed"] = max(worst["windowed"], d)  # #8 (FD) is #9
                    del st, want
                    ws = rg.fused_rb_gibbs_sweep_2d(x, bb, diag, coeffs, omega, 1234, 77, **kw)
                    with whole():
                        r6 = rg.fused_rb_gibbs_sweep(x, bb, diag, coeffs, omega, 1234, 77, **kw)
                    torch.cuda.synchronize()
                    d6 = (ws - r6).abs().max().item()
                    check(torch.equal(ws, r6), f"#8 (streamed) and #6 differ at {tag}: max |diff| {d6:.3e}")
                    del r6
                    want = rg.fused_rb_gibbs_sweep_2d_reference(x, bb, diag, coeffs, omega, 1234, 77, **kw)
                    r, d = rel_err(ws, want)
                    check(r <= tol, f"#8 (streamed) disagrees with its twin at {tag}: {r:.3e} > {tol:g}")
                    rels[noise] = max(rels[noise], r)
                    worst["windowed"] = max(worst["windowed"], d)
                    del ws, want
        print(f"  #9 and #8 (FD, streamed D) at {shape} omega {omega:g} kappa2 {fd[0]:g} hinv2 {fd[1]:g}: "
              f"forward/backward, noise on/off, b given/None: worst rel {rels[False]:.2e} noise off "
              f"(tol 1e-05), {rels[True]:.2e} noise on (tol 0.0001); #9 == #8 (FD) == #7 and "
              f"#8 (streamed) == #6 bit for bit")
        if shape == RAGGED_ODD:
            launch_report(f"#9 at {shape} (b)", "sweep_march", (1, 0), rg.sweep_plan(shape))
        if big:
            launch_report(f"{N_BIG}^3 #9, #8 FD (b)", "sweep_march", (1, 0), rg.sweep_plan(shape))
            launch_report(f"{N_BIG}^3 #8 (streamed D, b = None)", "sweep_march", (0, 1), rg.sweep_plan(shape))
            n = x.numel()
            args = (coeffs, omega, 1234, 77)
            t = {"#9": event_ms(torch, lambda: rg.fused_rb_gibbs_sweep_2d_staged(x, b, *args, fd_params=fd), 10),
                 "#8 FD": event_ms(torch, lambda: rg.fused_rb_gibbs_sweep_2d(x, b, None, *args, fd_params=fd,
                                                                            staged=False), 10),
                 "#8 streamed": event_ms(torch, lambda: rg.fused_rb_gibbs_sweep_2d(x, None, diag, *args), 10)}
            with whole():
                t["#7"] = event_ms(torch, lambda: rg.fused_rb_gibbs_sweep_fd(x, b, coeffs, *fd, *args[1:]), 10)
                t["#6"] = event_ms(torch, lambda: rg.fused_rb_gibbs_sweep(x, None, diag, *args), 10)
            t["twin FD"] = event_ms(torch, lambda: rg.fused_rb_gibbs_sweep_2d_staged_reference(
                x, b, *args, fd_params=fd), 2)
            t["twin streamed"] = event_ms(torch, lambda: rg.fused_rb_gibbs_sweep_2d_reference(
                x, None, diag, *args), 2)
            bms9, by9 = bound(sweep_bytes(n, True, False), FLOPS_SWEEP["fd"] * n)
            bms8, by8 = bound(sweep_bytes(n, False, True), FLOPS_SWEEP["streamed"] * n)
            rec["sweep_2d_staged"] = dict(max_abs_err=worst["staged"], ms=t["#9"], plain_ms=t["twin FD"],
                                          bound_ms=bms9, bound_by=by9, library_ms=None)
            rec["sweep_2d"] = dict(max_abs_err=worst["windowed"], ms=t["#8 streamed"],
                                   plain_ms=t["twin streamed"], bound_ms=bms8, bound_by=by8, library_ms=None)
            print(f"  {N_BIG}^3 device ms per call (noise on): with b #9 {t['#9']:.4f}, #8 (FD) {t['#8 FD']:.4f}, "
                  f"#7 {t['#7']:.4f}, twin {t['twin FD']:.4f} (bound {bms9:.4f}, {by9}); b = None, streamed D "
                  f"#8 {t['#8 streamed']:.4f}, #6 {t['#6']:.4f}, twin {t['twin streamed']:.4f} "
                  f"(bound {bms8:.4f}, {by8})")
        del x, b, diag

    # #7 (b, noise) at the levels below 0 of the 768^3 V(2,2) hierarchy, each
    # with its launch plan and coefficients: phase 18's 24 launches a step
    step = 0.0
    for o, sm in list(zip(big22.ops, big22.smoothers))[1:]:
        shape = tuple(o.grid_shape)
        x, b = randn(*shape), randn(*shape)
        args = (sm._coeff6(), *sm.fd_params, sm.omega, 1234, 77)
        t = queued_ms(torch, lambda: rg.fused_rb_gibbs_sweep_fd(x, b, *args), 20)
        step += 4 * t
        launch_report(f"#7 at {shape} (b)", "sweep_march", (1, 0), rg.full_sweep_plan(shape))
        print(f"  #7 at {shape} (b, noise): {t:.4f} ms")
        del x, b
    print(f"  #7 over the 768^3 V(2,2) step's 24 launches (4 a level): {step:.4f} ms")
    return rec


def phase_sweep2d_moments(torch, dev, b, gates):
    """The phase-7 problems with rb_gibbs._PLANE_LIMIT patched below their
    finest plane, so that the keyed chains take #9 (FD) and #8 (streamed D)
    there: each chain against phase 7's explicit-noise chain (the phase-4
    gates), exact launch counts, and its moments bit for bit phase 7's
    kernel chain (#7, #6).  Then the (32, 768, 768) keyed V(2,2) chain on
    its natural route (#9 at level 0) bit for bit the chain with level 0
    forced to #7, over 8 steps."""
    from parmgmc_tpu_torch import kernels, replay
    from parmgmc_tpu_torch.chain import init_chain, sample_chain
    from parmgmc_tpu_torch.kernels import rb_gibbs as rg
    from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    for label, (smp, bb, n) in moments_problems(torch, dev, b).items():
        v22 = label == "V(2,2)"
        shapes = [tuple(o.grid_shape) for o in smp.ops[:-1]] if v22 else [tuple(smp.grid_shape)]
        limit = shapes[0][1] * shapes[0][2] - 1  # the finest plane alone passes it
        check(all(s[1] * s[2] <= limit for s in shapes[1:]), f"{label}: levels {shapes} all pass {limit}")
        steps = n + 200
        if v22:
            per = {"rb_gibbs_2d_staged": 4, "rb_gibbs_fd": 4 * (len(shapes) - 1)}
        else:
            per = {"rb_gibbs_2d_staged": 2} if "FD" in label else {"rb_gibbs_2d": 1}
        kernels.reset_launch_counts()
        with mock.patch.object(rg, "_PLANE_LIMIT", limit):
            kern = chain_moments(torch, f"{label} large-plane kernel chain", smp, bb, n)
        counts = kernels.launch_counts(plain=False)
        expect = dict.fromkeys(counts, 0)
        expect.update({k: v * steps for k, v in per.items()})
        print(f"  launches: {counts} ({per} a step over {steps} steps)")
        check(counts == expect, f"{label}: the large-plane chain launched {counts}, expected {expect}")
        kern_whole, plain = gates[label]
        moments_check(torch, f"{label} through the large-plane kernels", kern, plain, 0.2)
        check(torch.equal(kern[0], kern_whole[0]) and torch.equal(kern[1], kern_whole[1]),
              f"{label}: the large-plane chain's moments differ from phase 7's whole-plane chain")
        print(f"  {label}: mean and variance bit for bit phase 7's kernel chain")

    op = shifted_laplace_fd((32, N_BIG, N_BIG), 1.0, device=dev)
    smp = MGMCSampler.create(op, n_pre=2, n_post=2, coarsest_size=128, coarsening="aggregate")
    bb = torch.full(op.grid_shape, 50.0, device=dev)
    levels = [tuple(o.grid_shape) for o in smp.ops]
    st = init_chain(smp, 5)
    kernels.reset_launch_counts()
    sa, qa = sample_chain(smp, st, bb, 8, extract=torch.mean)
    ca = kernels.launch_counts()
    kernels.reset_launch_counts()
    with mock.patch.object(rg, "_PLANE_LIMIT", 2**62), mock.patch.object(replay, "graphs_for", lambda *a: None):
        sb, qb = sample_chain(smp, st, bb, 8, extract=torch.mean)
    cb = kernels.launch_counts()
    smoothed = len(levels) - 1
    check(ca["rb_gibbs_2d_staged"] == 32 and ca["rb_gibbs_fd"] == 32 * (smoothed - 1)
          and cb["rb_gibbs_2d_staged"] == 0 and cb["rb_gibbs_fd"] == 32 * smoothed,
          f"the (32, {N_BIG}, {N_BIG}) V(2,2) chains launched {ca} and {cb}")
    check(torch.equal(sa.x, sb.x) and torch.equal(qa, qb),
          "the V(2,2) chain through #9 diverged bitwise from the chain through #7")
    print(f"  (32, {N_BIG}, {N_BIG}) b=50, levels {levels}: the keyed V(2,2) chain with #9 at level 0 "
          f"bit for bit the chain with #7 there over 8 steps")


def lrc_selftest_problem():
    """bench.py selftest_lrc's problem: (op, f), three balls of radius 0.2
    on (16, 16, 128) with sigma^2 = 0.05, from default_rng(5)."""
    import numpy as np

    from parmgmc_tpu_torch.models.obs import make_posterior_operator
    from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd

    rng = np.random.default_rng(5)
    coords = 0.2 + 0.6 * rng.random((3, 3))
    return make_posterior_operator(shifted_laplace_fd((16, 16, 128), 1.0), 0.05, coords,
                                   np.full(3, 0.2), rng.standard_normal(3))


def counted_moments(torch, label, smp, b, n, burnin, per_step):
    """chain_moments of smp, checking that the chain launched exactly
    per_step[counter] kernels a step of each counter and no other."""
    from parmgmc_tpu_torch import kernels

    kernels.reset_launch_counts()
    out = chain_moments(torch, label, smp, b, n, burnin)
    counts = kernels.launch_counts(plain=False)
    expect = dict.fromkeys(counts, 0)
    expect.update({k: v * (n + burnin) for k, v in per_step.items()})
    check(counts == expect, f"{label}: launched {counts}, expected {per_step} a step")
    return out


def phase_posterior_gates(torch, dev):
    from parmgmc_tpu_torch.chain import ExplicitNoise, init_chain, sample_chain, sample_chain_deferred
    from parmgmc_tpu_torch.operators.lrc import LRCOperator
    from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
    from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
    from parmgmc_tpu_torch.testing import lrc_chain_oracle

    op, f = lrc_selftest_problem()
    check(op.cols.windowed, "the selftest's observations have no window view")
    smp = MGMCSampler.create(op, **POST_V10)
    probe = smp.lrc_aux.probe
    check(smp._lrc_chain_eligible() and smp.deferred_eligible() and probe is not None,
          "the probed posterior chain route is not engaged")
    # a union pack needs a window view of each of its stacks (the JAX rule)
    can = {"coarse": smp.ops[1].cols.windowed, "fine": smp.smoothers[0].woodbury().windowed}
    packed = {"coarse": probe.coarse.packed, "fine": probe.fine.packed}
    check(packed == can, f"union packs {packed} against {can}")
    print(f"  levels {[o.grid_shape for o in smp.ops]}; probed route: Mb {tuple(probe.Mb.vals.shape)}, "
          f"RB {tuple(probe.RB.vals.shape)}; coarse union packed {packed['coarse']}, fine union packed "
          f"{packed['fine']} (B_c at level 1 windowed: {can['coarse']}, Bb windowed: {can['fine']})")
    legacy = dataclasses.replace(smp, lrc_aux=dataclasses.replace(smp.lrc_aux, probe=None))
    x0 = torch.randn(op.grid_shape, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    for route, s in (("probed", smp), ("b_eff", legacy)):
        for tag, b in (("b=f", f), ("b=None", None)):
            _, got = s.step(3, x0, b)
            rel, _ = rel_err(got, lrc_chain_oracle(s, 3, x0, b))
            print(f"  chain step vs its materialised form ({route}, {tag}): rel {rel:.3e} (gate 1e-3)")
            check(rel < 1e-3, f"the LRC chain step's rank-k algebra disagrees ({route}, {tag})")
    st = init_chain(smp, 5)
    sa, qa = sample_chain(smp, st, f, 8, extract=torch.mean)
    sb, qb = sample_chain_deferred(smp, st, f, 8)
    rs, rq = rel_err(sb.x, sa.x)[0], rel_err(qb, qa)[0]
    print(f"  deferred posterior chain vs sample_chain over 8 steps: state rel {rs:.3e}, QOI rel {rq:.3e} "
          "(gates 1e-3)")
    check(rs < 1e-3 and rq < 1e-3, "the deferred posterior chain diverged from sample_chain")

    smoothed = smp.n_levels - 2
    kern = counted_moments(torch, "posterior MGMC kernel chain", smp, f, N_POST_MOMENTS, 200,
                           {"chain_down": 1, "rb_gibbs_fd": smoothed})
    plain = counted_moments(torch, "posterior MGMC plain chain", ExplicitNoise(smp), f, N_POST_MOMENTS, 200, {})
    moments_check(torch, "posterior MGMC", kern, plain, 0.2)
    # standalone Gibbs needs a well-conditioned base, as in bench.py
    g = GibbsSampler.create(LRCOperator(shifted_laplace_fd(op.grid_shape, 40.0), op.B, op.sigma_inv),
                            sweep="symmetric")
    check(g.has_kernel and g.is_lrc, "the LRC Gibbs sampler does not take the sweep kernel")
    kern = counted_moments(torch, "posterior Gibbs kernel chain", g, f, N_POST_MOMENTS, 500, {"rb_gibbs_fd": 2})
    plain = counted_moments(torch, "posterior Gibbs plain chain", ExplicitNoise(g), f, N_POST_MOMENTS, 500, {})
    moments_check(torch, "posterior Gibbs", kern, plain, 0.25)


def fd_eigen_solve(torch, v, kappa2, hinv2):
    """A^{-1} v for the link-count FD operator kappa2 + hinv2 L on v's
    grid: L is a sum of path-graph Laplacians, one an axis, so the
    eigenvectors of the three small ones diagonalise A (float64)."""
    eig = []
    for n in v.shape:
        lap = torch.diag(torch.full((n,), 2.0, dtype=torch.float64, device=v.device))
        lap -= torch.diag(torch.ones(n - 1, dtype=torch.float64, device=v.device), 1)
        lap -= torch.diag(torch.ones(n - 1, dtype=torch.float64, device=v.device), -1)
        lap[0, 0] = lap[-1, -1] = 1.0
        eig.append(torch.linalg.eigh(lap))
    w = v.double()
    for ax, (_, Q) in enumerate(eig):  # into the eigenbasis, axis by axis
        w = torch.movedim(torch.tensordot(w, Q, dims=([ax], [0])), -1, ax)
    lam = eig[0][0].reshape(-1, 1, 1) + eig[1][0].reshape(1, -1, 1) + eig[2][0].reshape(1, 1, -1)
    w = w / (kappa2 + hinv2 * lam)
    for ax, (_, Q) in enumerate(eig):
        w = torch.movedim(torch.tensordot(w, Q.T, dims=([ax], [0])), -1, ax)
    return w


def posterior_qoi_law(torch, op, obsvals):
    """(E, Var) of mean(x) for x ~ N(A_post^{-1} f, A_post^{-1}), A_post =
    A + B Sigma^{-1} B^T, f = B Sigma^{-1} y, A link-count FD (A 1 = kappa2
    1): with u = B^T A^{-1} 1 = B^T 1 / kappa2, S = (Sigma + B^T A^{-1}
    B)^{-1} and g = Sigma^{-1} y,
        1^T A_post^{-1} 1 = N / kappa2 - u^T S u,
        1^T A_post^{-1} f = u^T (I - S B^T A^{-1} B) g,
    in float64, A^{-1} B by the base's eigendecomposition."""
    from parmgmc_tpu_torch.operators.stencil import detect_fd_params

    kappa2, hinv2 = detect_fd_params(op.base)
    B = op.B.double()
    n = op.n
    grid = list(range(op.ndim))
    AiB = torch.stack([fd_eigen_solve(torch, B[..., j], kappa2, hinv2) for j in range(op.k)], dim=-1)
    BtAiB = torch.tensordot(B, AiB, dims=(grid, grid))
    s_inv = op.sigma_inv.double()
    S = torch.linalg.inv(torch.diag(1.0 / s_inv) + BtAiB)
    u = B.sum(dim=grid) / kappa2
    g = s_inv * torch.as_tensor(obsvals, dtype=torch.float64, device=B.device)
    var_sum = n / kappa2 - u @ S @ u
    mean_sum = u @ (g - S @ (BtAiB @ g))
    return (mean_sum / n).item(), (var_sum / n**2).item()


def phase_posterior_path(torch, dev):
    """bench.py --posterior at 256^3 through sample_chain_deferred (b = f)."""
    import numpy as np

    from parmgmc_tpu_torch import kernels, keys, replay
    from parmgmc_tpu_torch.chain import init_chain, sample_chain_deferred
    from parmgmc_tpu_torch.diagnostics.iact import iact
    from parmgmc_tpu_torch.kernels import mg_sweep, rb_gibbs
    from parmgmc_tpu_torch.kernels._noise import CHAIN_DOMAIN
    from parmgmc_tpu_torch.models.obs import make_posterior_operator
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.samplers import gibbs, mgmc
    from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
    from parmgmc_tpu_torch.samplers.gibbs import GibbsSampler
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    k = 5
    rng = np.random.default_rng(0)
    coords = 0.15 + 0.7 * rng.random((k, 3))
    obsvals = rng.standard_normal(k)
    (op, f), t_obs = timed(lambda: make_posterior_operator(gmrf_3d(N_MAIN, kappa=1.0), 0.01, coords,
                                                           np.full(k, 0.12), obsvals))
    check(op.device.type == "cuda" and op.cols.windowed, "the 256^3 posterior operator")
    smp, t_create = timed(lambda: MGMCSampler.create(op, **POST_V10))
    probe = smp.lrc_aux and smp.lrc_aux.probe
    check(smp._lrc_chain_eligible() and smp.deferred_eligible() and probe is not None
          and probe.fine.packed and probe.coarse.packed,
          "the probed posterior route with both union packs is not engaged")
    print(f"  levels {[o.grid_shape for o in smp.ops]}; B windows {tuple(op.cols.vals.shape)}; "
          f"Mb {tuple(probe.Mb.vals.shape)}, RB {tuple(probe.RB.vals.shape)}, "
          f"FW {tuple(probe.fine.vals.shape)}, CW {tuple(probe.coarse.vals.shape)}")
    # the same set-up again, part by part
    (ops, trs), t_hier = timed(lambda: mgmc.build_hierarchy(op, coarsest_size=128, coarsening="aggregate"))
    t_bb = [timed(lambda o=o: GibbsSampler.create(o))[1] for o in ops[:-1]]
    _, t_chol = timed(lambda: CholeskySampler.create(ops[-1]))
    _, t_aux = timed(lambda: mgmc.compute_lrc_aux(smp.ops, smp.transfers, smp.smoothers))
    bare = dataclasses.replace(smp, lrc_aux=dataclasses.replace(smp.lrc_aux, probe=None))
    _, t_attach = timed(lambda: mgmc.attach_chain_b_response(bare))
    x0 = torch.zeros(op.grid_shape, device=dev)
    cols = [x0] + [op.B[..., j].contiguous() for j in range(k)]
    # the probe calls draw under key 0, as attach_chain_b_response's do
    probe = keys.Words()
    probe.launch(*keys.draw_pair(0)[1:], (CHAIN_DOMAIN,))
    _, t_probe = timed(lambda: [smp._fused_chain_down(x0, c, probe.cursor()) for c in cols])
    print(f"  set-up: observations {t_obs:.2f} s; MGMCSampler.create {t_create:.2f} s; part by part: "
          f"hierarchy (B_c) {t_hier:.2f} s, Bb by level " + ", ".join(f"{t:.2f}" for t in t_bb)
          + f" s, coarse Cholesky {t_chol:.2f} s, rank-k matrices {t_aux:.2f} s, probe and packs "
          f"{t_attach:.2f} s (of which the {k + 1} probe calls of #1 {t_probe:.2f} s)")
    del bare

    st = init_chain(smp, 0)
    st, _ = sample_chain_deferred(smp, st, f, 64)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    st, _ = sample_chain_deferred(smp, st, f, N_TIME)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / N_TIME
    st, q = sample_chain_deferred(smp, st, f, N_IACT)
    q = q.double().cpu()
    torch.cuda.synchronize()
    counts = kernels.launch_counts(plain=False)
    steps = N_TIME + N_IACT
    print(f"  launches during the posterior path ({steps} steps): {counts}")
    expect = dict(dict.fromkeys(counts, 0), chain_down=steps, rb_gibbs_fd=(smp.n_levels - 2) * steps,
                  chain_step_graph=steps)
    check(counts == expect, f"the posterior path launched {counts}, expected {expect}")
    x = st.x
    check(tuple(x.shape) == op.grid_shape and bool(torch.isfinite(x).all()), "final posterior state not finite")
    check(bool(torch.isfinite(q).all()) and q.shape == (N_IACT,), "posterior QOI chain not finite")
    dq = abs(q[-1].item() - x.double().mean().item())
    check(dq < 1e-6 + 1e-4 * q.abs().max().item(), f"last QOI != mean of final state ({dq:.2e})")
    m, v = posterior_qoi_law(torch, op, obsvals)
    tau, valid = iact(q)
    tau_c = max(tau, 1.0)
    var_ratio = q.var().item() / v
    zmean = (q.mean().item() - m) / math.sqrt(v / N_IACT)
    print(f"  QOI: mean {q.mean().item():.6e} (exact {m:.6e}), mean / SE off {zmean:.3f}, var / exact "
          f"{var_ratio:.4f}, tau {tau:.4f} (valid {valid})")
    check(0.8 < var_ratio < 1.25, "posterior QOI variance is off its exact value")
    check(abs(zmean) < 5.0 * math.sqrt(tau_c), "posterior QOI mean is off its exact value")
    ess = 1.0 / (tau_c * dt)
    print(f"  {N_MAIN}^3 posterior path: {dt * 1e3:.4f} ms/cycle, tau {tau:.4f}, ESS/sec {ess:.2f}")

    holder, n_win = [st], 32
    del st, x

    def window():
        holder[0], _ = sample_chain_deferred(smp, holder[0], f, n_win)

    busy, per = device_ms(torch, window, 1)
    busy, per = busy / n_win, {name: t / n_win for name, t in per.items()}
    for name, t in sorted(per.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device per step: {t:.4f} ms  {name}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    launched = sum(a.count for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA)
    print(f"  device kernels and copies a step: {launched / n_win:.1f} (profiler, a window of {n_win})")
    # a step launches ~200 kernels: queue single steps behind the sleeping
    # kernel (a window of many fills the launch queue and waits on the host)
    carry = [holder[0].x, smp.deferred_init(torch.float32, holder[0].x)]

    def one_step():
        _, carry[0], carry[1], _, _ = smp.step_deferred(1, carry[0], carry[1], f)

    queued = queued_ms(torch, one_step, 2)
    idle = max(0.0, 1.0 - busy / (dt * 1e3))
    print(f"  device busy {busy:.4f} ms/step (profiler), {queued:.4f} ms/step back to back (queued), "
          f"of {dt * 1e3:.4f} ms/cycle: idle share ~{idle:.3f} (profiler)")
    del carry

    # the same keyed steps with the twins in place of the kernels (the eager
    # step: a replayed graph holds the kernels)
    st = holder[0]
    sa, _ = sample_chain_deferred(smp, st, f, 8)
    with mock.patch.object(mg_sweep, "fused_chain_down_fd", mg_sweep.fused_chain_down_fd_reference), \
            mock.patch.object(gibbs, "fused_rb_gibbs_sweep_fd", rb_gibbs.fused_rb_gibbs_sweep_fd_reference), \
            mock.patch.object(replay, "graphs_for", lambda *a: None):
        sb, _ = sample_chain_deferred(smp, st, f, 8)
    rel, _ = rel_err(sa.x, sb.x)
    print(f"  8 keyed steps on the kernels vs on the twins: state rel {rel:.3e} (gate 1e-4)")
    check(rel < 1e-4, "the posterior path on the kernels disagrees with its twins")


def galerkin_exactness(torch, dev, ops, transfers, label):
    """The coarse stencils of levels 1 and 2 against R(A(P x)) on three
    seeded random fields each: the worst relative max-norm error."""
    gen = torch.Generator(device=dev).manual_seed(21)
    worst = 0.0
    for l in (0, 1):
        for _ in range(3):
            x = torch.randn(ops[l + 1].grid_shape, generator=gen, device=dev)
            want = transfers[l].restrict(ops[l].apply(transfers[l].prolong(x)))
            worst = max(worst, rel_err(ops[l + 1].apply(x), want)[0])
    print(f"  {label}: A_c x against R(A(P x)) at levels 1 and 2, three fields each: "
          f"rel {worst:.3e} (gate 1e-5)")
    check(worst < 1e-5, f"{label}: a Galerkin level disagrees with R A P")


def timed_hierarchy(torch, op, **kw):
    """build_hierarchy(op, **kw) with the set-up time of each coarse level
    (comb probe and compression) and the peak device memory."""
    from parmgmc_tpu_torch.samplers import mgmc

    probe, compress = mgmc.galerkin_coarse_operator, mgmc.compress_stencil
    times = []

    def timed(fn):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out
        return run

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(mgmc, "galerkin_coarse_operator", timed(probe)), \
            mock.patch.object(mgmc, "compress_stencil", timed(compress)):
        ops, transfers = mgmc.build_hierarchy(op, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return ops, transfers, [a + b for a, b in zip(times[0::2], times[1::2])], total, torch.cuda.max_memory_allocated()


def twin_steps(torch, smp, st, b, n=8):
    """Relative max-norm gap between n keyed steps of smp from st on the
    kernels and the same steps, eager, with the FD sweep's, the 27-point
    sweep's, the residual's and the prolong-add's twins in their place."""
    from parmgmc_tpu_torch import replay
    from parmgmc_tpu_torch.chain import sample_chain
    from parmgmc_tpu_torch.kernels import galerkin_sweep, prolong_add, rb_gibbs, residual_restrict
    from parmgmc_tpu_torch.samplers import gibbs

    sa, _ = sample_chain(smp, st, b, n)
    with mock.patch.object(gibbs, "fused_rb_gibbs_sweep_fd", rb_gibbs.fused_rb_gibbs_sweep_fd_reference), \
            mock.patch.object(gibbs, "fused_galerkin_sweep",
                              lambda *a, prefix_at=None, packed=None, **k:
                              galerkin_sweep.fused_galerkin_sweep_reference(*a, **k)), \
            mock.patch.object(residual_restrict, "residual_restrict",
                              lambda *a, packed=None, **k: residual_restrict.residual_restrict_reference(*a, **k)), \
            mock.patch.object(prolong_add, "prolong_add", prolong_add.prolong_add_reference), \
            mock.patch.object(replay, "graphs_for", lambda *a: None):
        sb, _ = sample_chain(smp, st, b, n)
    check(bool(torch.isfinite(sa.x).all()), "the keyed chain's state is not finite")
    return rel_err(sa.x, sb.x)[0]


def residual_checks(torch, smp, label, timed=False):
    """The residual kernel against its twin, bit for bit, on every smoothed
    level of smp's linear hierarchy: both forms, b given and None.  With
    ``timed``, the device time of a step's calls (the fine residual alone,
    b None, then each level's residual and restriction), queued behind a
    sleeping kernel, beside the twin's and the bound of their bytes.
    Returns the kernel's ms a step (0.0 untimed)."""
    from parmgmc_tpu_torch.kernels import residual_restrict as rr
    from parmgmc_tpu_torch.operators.stencil import coarse_shape

    gen = torch.Generator(device=smp.device).manual_seed(13)
    for l in range(smp.n_levels - 1):
        op, pack = smp.ops[l], smp.residual_packs[l]
        check(pack is not None, f"{label}: level {l} has no residual pack")
        x, b = (torch.randn(op.grid_shape, generator=gen, device=smp.device) for _ in range(2))
        for restrict in (True, False):
            for bb in (b, None):
                want = rr.residual_restrict_reference(x, bb, op, restrict=restrict)
                got = rr.residual_restrict(x, bb, op, restrict=restrict, packed=pack)
                check(torch.equal(got, want), f"{label}: the residual kernel differs from its twin at level "
                      f"{l} {op.grid_shape} (restrict {restrict}, b {bb is not None}): rel {rel_err(got, want)[0]:.3e}")
    print(f"  {label}: the residual kernel equals its twin bit for bit on every level, both forms, b and None")
    if not timed:
        return 0.0
    total = 0.0
    for l, restrict in [(0, False)] + [(m, True) for m in range(smp.n_levels - 1)]:
        op, pack = smp.ops[l], smp.residual_packs[l]
        x, b = (torch.randn(op.grid_shape, generator=gen, device=smp.device) for _ in range(2))
        bb = b if restrict else None
        pts, out = math.prod(op.grid_shape), math.prod(coarse_shape(op.grid_shape) if restrict else op.grid_shape)
        streams = 1 + (bb is not None) + (pack.diag is not None) + sum(f is not None for f in pack.fields)
        t = queued_ms(torch, lambda: rr.residual_restrict(x, bb, op, restrict=restrict, packed=pack), 20)
        tt = event_ms(torch, lambda: rr.residual_restrict_reference(x, bb, op, restrict=restrict), 5)
        lb = bound(4 * (streams * pts + out), 0)[0]
        total += t
        print(f"    {op.grid_shape} {'restrict' if restrict else 'alone'}: {t * 1e3:.2f} us (bound {lb * 1e3:.2f} us, "
              f"{100 * lb / t:.1f} %), twin {tt * 1e3:.1f} us")
    print(f"  {label}: a step's {smp.n_levels} residual calls {total:.4f} ms")
    return total


def prolong_checks(torch, smp, label, timed=False):
    """The prolong-add kernel against its twin, bit for bit, on every
    smoothed level of smp's linear hierarchy (y on the level, z on the next),
    into a new tensor, a separate buffer and y itself.  With ``timed``, the
    device time of a step's calls, queued behind a sleeping kernel, beside
    the twin's and the bound of their bytes (y and z read, the output
    written).  Returns the kernel's ms a step (0.0 untimed)."""
    from parmgmc_tpu_torch.kernels import prolong_add as pa

    gen = torch.Generator(device=smp.device).manual_seed(14)
    fields = []
    for l in range(smp.n_levels - 1):
        y, z = (torch.randn(smp.ops[m].grid_shape, generator=gen, device=smp.device) for m in (l, l + 1))
        check(pa.takes(y, z, smp.transfers[l].fine_shape), f"{label}: the prolong-add kernel does not take level {l}")
        want = pa.prolong_add_reference(y, z)
        for form in ("new", "separate", "y"):
            yy = y.clone()
            got = pa.prolong_add(yy, z, out={"new": None, "separate": torch.empty_like(y), "y": yy}[form])
            check(torch.equal(got, want), f"{label}: the prolong-add kernel differs from its twin at level "
                  f"{l} {tuple(y.shape)} (out {form}): rel {rel_err(got, want)[0]:.3e}")
        fields.append((y, z))
    print(f"  {label}: the prolong-add kernel equals its twin bit for bit on every level, three out forms")
    if not timed:
        return 0.0
    total = 0.0
    for y, z in fields:
        t = queued_ms(torch, lambda: pa.prolong_add(y, z), 20)
        tg = queued_ms(torch, lambda: pa.prolong_add(y, z, out=y), 20)
        tt = event_ms(torch, lambda: pa.prolong_add_reference(y, z), 5)
        lb = bound(4 * (2 * y.numel() + z.numel()), 0)[0]
        total += t
        print(f"    {tuple(y.shape)}: {t * 1e3:.2f} us, in place {tg * 1e3:.2f} us (bound {lb * 1e3:.2f} us, "
              f"{100 * lb / t:.1f} %), twin {tt * 1e3:.1f} us")
    print(f"  {label}: a step's {len(fields)} prolong-add calls {total:.4f} ms")
    return total


def counted_steps(torch, label, smp, n, per_step):
    """n keyed steps of smp (b = None) from a fixed start, checking that
    they launched exactly per_step[counter] kernels a step of each counter
    and no other, and, where its words allow a capture, that every step
    after the first (a new sampler's, run eagerly and then captured) was a
    replay; the final chain state."""
    from parmgmc_tpu_torch import kernels
    from parmgmc_tpu_torch.chain import init_chain, sample_chain

    st = init_chain(smp, 3)
    kernels.reset_launch_counts()
    st, _ = sample_chain(smp, st, None, n)
    torch.cuda.synchronize()
    counts = kernels.launch_counts(plain=False)
    expect = dict(dict.fromkeys(counts, 0), **{k: v * n for k, v in per_step.items()})
    expect["chain_step_graph"] = n - 1 if smp.keyed_words(0).replayable else 0
    check(counts == expect, f"{label}: launched {counts}, expected {per_step} a step")
    check(bool(torch.isfinite(st.x).all()), f"{label}: the state is not finite")
    print(f"  {label}: {n} keyed steps launched {per_step} a step and no other kernel")
    return st


def phase_linear(torch, dev):
    from parmgmc_tpu_torch.chain import ExplicitNoise
    from parmgmc_tpu_torch.kernels.galerkin_sweep import LAUNCHES
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.operators.transfer import GeometricTransfer
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    for n in (N_MAIN, N_BIG):
        ops, transfers, per_level, total, peak = timed_hierarchy(torch, gmrf_3d(n, kappa=1.0))
        check(all(isinstance(t, GeometricTransfer) for t in transfers), "the default hierarchy is not linear")
        print(f"  {n}^3 linear hierarchy: {total:.2f} s, peak device memory {peak / 2**30:.2f} GiB")
        for o, t in zip(ops[1:], per_level):
            fields = sum(c.ndim > 0 for c in o.coeffs)
            print(f"    {o.grid_shape}: set-up {t:.3f} s, {len(o.offsets)} offsets kept, {fields} of them fields")
        galerkin_exactness(torch, dev, ops, transfers, f"{n}^3")
        del ops, transfers
        torch.cuda.empty_cache()

    # moments: level 0 on #7, the exact coarse sample of the Galerkin 8^3
    smp = MGMCSampler.create(gmrf_3d(16, kappa=1.0), n_pre=2, n_post=2)
    check(smp.n_levels == 2 and smp.smoothers[0].has_kernel, f"gmrf_3d(16) levels {smp.n_levels}")
    b = torch.full(smp.grid_shape, 50.0, device=dev)
    kern = counted_moments(torch, "linear V(2,2) kernel chain", smp, b, N_POST_MOMENTS, 200,
                           {"rb_gibbs_fd": 4, "residual_restrict": 2, "prolong_add": 1})
    plain = counted_moments(torch, "linear V(2,2) plain chain", ExplicitNoise(smp), b, N_POST_MOMENTS, 200, {})
    moments_check(torch, "linear V(2,2)", kern, plain, 0.2)

    # odd extents: level 0 on #7 ("any 3D shape"), the Galerkin levels on
    # the 27-point kernel (colours of unequal sizes)
    odd = MGMCSampler.create(gmrf_3d(129, kappa=1.0), n_pre=2, n_post=2)
    levels = [o.grid_shape for o in odd.ops]
    check(levels == [(m,) * 3 for m in (129, 65, 33, 17, 9)], f"gmrf_3d(129) levels {levels}")
    residual_checks(torch, odd, "129^3")
    prolong_checks(torch, odd, "129^3")
    st = counted_steps(torch, "129^3 linear V(2,2)", odd, 8,
                       {"rb_gibbs_fd": 4, "galerkin_sweep": 12 * LAUNCHES, "residual_restrict": 5,
                        "prolong_add": 4})
    rel = twin_steps(torch, odd, st, None)
    print(f"  129^3 linear V(2,2): 8 keyed steps on the kernels vs on the twins: state rel {rel:.3e} (gate 1e-4)")
    check(rel < 1e-4, "the odd-extent linear cycle on the kernels disagrees with its twins")
    agg = MGMCSampler.create(gmrf_3d(33, kappa=1.0), n_pre=2, n_post=2, coarsening="aggregate")
    levels = [o.grid_shape for o in agg.ops]
    check(levels == [(m,) * 3 for m in (33, 17, 9)] and not agg.smoothers[1].has_kernel
          and any(c.ndim > 0 for c in agg.ops[1].coeffs), f"gmrf_3d(33) aggregate levels {levels}")
    counted_steps(torch, "33^3 aggregate V(2,2)", agg, 8, {"rb_gibbs_fd": 4})

    # F3: the V(1,0) cycle shape on a linear hierarchy runs the general cycle
    f3 = MGMCSampler.create(gmrf_3d(32, kappa=1.0), n_levels=2, n_pre=1, n_post=0)
    check(f3.smoothers[0].fd_params is not None and not f3.deferred_eligible(),
          "a linear V(1,0) sampler is deferred-eligible")
    counted_steps(torch, "32^3 two-level linear V(1,0)", f3, 8,
                  {"rb_gibbs_fd": 1, "residual_restrict": 2, "prolong_add": 1})
    refused = False
    try:
        f3.step_deferred(0, torch.zeros(f3.grid_shape, device=dev), f3.deferred_init(torch.float32), None)
    except NotImplementedError:
        refused = True
    check(refused, "step_deferred ran a linear V(1,0) sampler")
    print("  32^3 two-level linear V(1,0): not deferred-eligible, step_deferred refuses it")


def phase_linear_path(torch, dev):
    """MGMCSampler.create(gmrf_3d(256), n_pre=2, n_post=2): the JAX
    package's default V(2,2) at 256^3."""
    from parmgmc_tpu_torch.kernels.galerkin_sweep import LAUNCHES
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.operators.transfer import GeometricTransfer
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smp = MGMCSampler.create(gmrf_3d(N_MAIN), n_pre=2, n_post=2)
    torch.cuda.synchronize()
    levels = [o.grid_shape for o in smp.ops]
    check(smp.device.type == "cuda" and all(isinstance(t, GeometricTransfer) for t in smp.transfers)
          and levels == [(m,) * 3 for m in (256, 128, 64, 32, 16, 8)],
          f"the default 256^3 sampler: {smp.device}, levels {levels}")
    check(smp.smoothers[0].route == "fused_rb_gibbs_sweep_fd"
          and all(s.route == "fused_galerkin_sweep" for s in smp.smoothers[1:]),
          "level 0 should take #7 and the 27-point levels the 27-point sweep kernel")
    print(f"  levels {levels}, create {time.perf_counter() - t0:.2f} s; chain of {N_LINEAR_IACT} steps for tau")
    residual_checks(torch, smp, f"{N_MAIN}^3", timed=True)
    prolong_checks(torch, smp, f"{N_MAIN}^3", timed=True)
    counts, st = phase_v22(torch, smp, {"rb_gibbs_fd": 4, "galerkin_sweep": 16 * LAUNCHES, "residual_restrict": 6,
                                        "prolong_add": 5},
                           n_time=N_LINEAR_TIME, n_iact=N_LINEAR_IACT, n_warm=4, twin=False, n_win=2)
    rel = twin_steps(torch, smp, st, None)
    print(f"  8 keyed steps on the kernels vs on the twins: state rel {rel:.3e} (gate 1e-4)")
    check(rel < 1e-4, "the default V(2,2) path on the kernels disagrees with its twins")
    return counts


def wrench_preset():
    """examples/benchmark/wrench.json: the reference's wrench.opts (kappa 5,
    three ball observations at sigma^2 = 1e-6, the rect QOI region)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), WRENCH_PRESET)) as f:
        return json.load(f)


def mesh_stage_timers(torch):
    """(patches, seconds): mock patches that add each mesh set-up stage's
    host seconds (ended by a device synchronise) to ``seconds``: reading
    and refining the mesh, assembly (and the observation matrices), the
    greedy colouring, the ELL arrays' upload, aggregation (strength graph,
    aggregates, smoothed P, Galerkin product) and the geometric Galerkin
    hierarchy."""
    from parmgmc_tpu_torch.models import mesh
    from parmgmc_tpu_torch.operators import aggregation, graph

    seconds = {}

    def timer(stage, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            seconds[stage] = seconds.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return run

    targets = ((mesh, "read_gmsh", "read+refine"), (mesh, "refine", "read+refine"),
               (mesh, "matern_precision_mesh", "assembly"), (mesh, "mesh_observation_mats", "assembly"),
               (graph, "greedy_coloring", "colouring"), (graph, "graph_operator", "upload"),
               (aggregation, "smoothed_aggregation_level", "aggregation"),
               (mesh, "geometric_mgmc_hierarchy", "geometric Galerkin"))
    return [mock.patch.object(m, name, timer(stage, getattr(m, name))) for m, name, stage in targets], seconds


def build_mesh_sampler(torch, label, **kw):
    """MaternMeshSampler(**kw) on the card with the host seconds of each
    set-up stage, the levels (DOFs, colours, ELL widths) and the peak
    device memory printed."""
    from contextlib import ExitStack

    from parmgmc_tpu_torch.models.matern import MaternMeshSampler

    patches, seconds = mesh_stage_timers(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    with ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        ms = MaternMeshSampler(mesh_file="wrench", **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    smp = ms.sampler
    bases = [getattr(o, "base", o) for o in smp.ops]
    check(ms.op.device.type == "cuda" and all(b.device.type == "cuda" for b in bases),
          f"{label}: the operators are not on the card")
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
    print(f"  {label}: {ms.n} DOFs, set-up {total:.3f} s ({stages}), "
          f"peak device memory {(torch.cuda.max_memory_allocated() - held) / 2**20:.1f} MiB above the "
          f"{held / 2**20:.1f} MiB held before")
    print(f"    levels {[b.n for b in bases]}, colours {[b.ncolors for b in bases]}, "
          f"ELL widths {[b.vals.shape[1] for b in bases]}, smoothers "
          f"V({smp.n_pre},{smp.n_post}), coarsest {type(smp.coarse).__name__}")
    return ms


def phase_mesh_setup(torch):
    """Wrench refine 3 (posterior, float64; prior, float32) and refine 4
    (prior) on the card; the native colouring and aggregation against
    their Python twins on refine 3."""
    import numpy as np

    from parmgmc_tpu_torch import native
    from parmgmc_tpu_torch.models import mesh
    from parmgmc_tpu_torch.models.matern import observations_of
    from parmgmc_tpu_torch.operators.aggregation import _strength_graph, aggregate_py
    from parmgmc_tpu_torch.operators.graph import ell_csr, greedy_coloring_py

    preset = wrench_preset()
    kappa = float(preset["kappa"])
    post = build_mesh_sampler(torch, "refine-3 posterior (float64)", refinements=3, kappa=kappa,
                              observations=observations_of(preset), coarsest_size=128)
    check(post.n == 38132 and post.sampler.n_levels == 3, f"refine-3 wrench: {post.n} DOFs")
    prior32 = build_mesh_sampler(torch, "refine-3 prior (float32)", refinements=3, kappa=kappa,
                                 dtype=torch.float32, coarsest_size=128)
    check(torch.equal(prior32.op.perm, post.op.perm), "the float32 operator is coloured differently")
    prior4 = build_mesh_sampler(torch, "refine-4 prior (float64)", refinements=4, kappa=kappa, coarsest_size=128)
    check(prior4.n == 277544 and prior4.sampler.n_levels == 5, f"refine-4 wrench: {prior4.n} DOFs")

    t0 = time.perf_counter()
    A = mesh.matern_precision_mesh(post.points, post.cells, kappa)
    n = A.shape[0]
    same = np.array_equal(native.greedy_coloring(A.indptr, A.indices, n), greedy_coloring_py(A.indptr, A.indices, n))
    S = _strength_graph(ell_csr(post.op), 0.02)
    agg, n_agg = native.aggregate(S.indptr, S.indices, n)
    agg_py, n_agg_py = aggregate_py(S)
    same_agg = np.array_equal(agg, agg_py) and n_agg == n_agg_py
    print(f"  refine 3: native colouring {'==' if same else '!='} its Python twin, native aggregation "
          f"({n_agg} aggregates) {'==' if same_agg else '!='} its twin, bit for bit "
          f"({time.perf_counter() - t0:.2f} s)")
    check(same and same_agg, "the native graph set-up disagrees with its Python twin")
    return preset, post, prior32, prior4


def exact_qoi_law(torch, op, w_int, b=None):
    """(mean, var) of the QOI w^T x under N(A^{-1} b, A^{-1}) of ``op`` (LRC:
    the posterior), from the host's sparse LDL^T in float64."""
    from parmgmc_tpu_torch.samplers.cholesky import SparseCholeskySampler

    sc = SparseCholeskySampler.create(op)
    mean = 0.0 if b is None else float(w_int.double() @ sc.mean(b))
    return mean, float(w_int.double() @ sc.mean(w_int)), sc


def qoi_gates(torch, label, q, exact_mean, exact_var, gate_mean=True):
    """Mean within 4 standard errors (SE = sqrt(var tau / N)) and variance
    ratio in (0.8, 1.25) of the QOI traces q (C, N) against its exact law;
    returns the mean tau over the chains."""
    import numpy as np

    from parmgmc_tpu_torch.diagnostics.iact import iact

    q = q.double().cpu()
    taus, _ = iact(q)
    tau = float(np.maximum(taus, 1.0).mean())
    qm, qv = q.mean().item(), q.var().item()
    se = math.sqrt(exact_var * tau / q.numel())
    ratio = qv / exact_var
    print(f"  {label}: QOI over {q.shape[0]} chains x {q.shape[1]} steps: mean {qm:.6e} (exact {exact_mean:.6e}, "
          f"|z| {abs(qm - exact_mean) / se:.3f}, gate 4), var / exact {ratio:.4f} (gate 0.8..1.25), mean tau {tau:.4f}")
    if gate_mean:
        check(abs(qm - exact_mean) < 4.0 * se, f"{label}: the QOI mean is off its exact value")
    check(0.8 < ratio < 1.25, f"{label}: the QOI variance is off its exact value")
    return tau


def chain_major(torch, smp, b, w_int, C, burnin, n, key=5, field=False):
    """(q (C, n), wall seconds of the n recorded steps, field sum (n_dof,)
    or None): C chains chain-major through sample_chain from zero, the QOI
    w^T x of each chain recorded after ``burnin`` steps; with ``field`` the
    recorded states are summed on the card."""
    from parmgmc_tpu_torch.chain import init_chain, sample_chain

    st = init_chain(smp, key, batch=(C,))
    check(tuple(st.x.shape) == (smp.grid_shape[0], C), "chain-major state shape")
    st, _ = sample_chain(smp, st, b, burnin, extract=lambda x: w_int @ x)
    acc = torch.zeros_like(st.x) if field else None

    def extract(x):
        if acc is not None:
            acc.add_(x)
        return w_int @ x

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, q = sample_chain(smp, st, b, n, extract=extract)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(st.x).all()) and tuple(q.shape) == (n, C), "the chain-major chain is not finite")
    return q.T, dt, (None if acc is None else acc.sum(dim=1))


def phase_mesh_gates(torch, preset, post, prior32):
    """The exact laws from the host's SparseCholeskySampler (float64) and
    the 256-chain gates: the refine-3 posterior's QOI mean and variance and
    its field mean, the float32 prior's QOI variance, the geometric
    hierarchy's and the graph patch-Gibbs sampler's."""
    from parmgmc_tpu_torch.models import mesh
    from parmgmc_tpu_torch.models.matern import region_qoi
    from parmgmc_tpu_torch.operators.graph import from_csr
    from parmgmc_tpu_torch.samplers.patch_gibbs import GraphPatchGibbsSampler

    kappa = float(preset["kappa"])
    w = region_qoi(post.points, preset)
    w_int = torch.as_tensor(w[post.op.perm.cpu().numpy()], device=post.b.device)
    t0 = time.perf_counter()
    mu_q, var_q, sc = exact_qoi_law(torch, post.operator, w_int, post.b)
    mu = sc.mean(post.b)
    _, var_prior, _ = exact_qoi_law(torch, post.op, w_int)
    print(f"  exact laws (host SuperLU LDL^T, float64): {time.perf_counter() - t0:.2f} s; "
          f"{int((w > 0).sum())} QOI nodes; posterior QOI mean {mu_q:.6e}, var {var_q:.6e}; prior var {var_prior:.6e}")

    C = N_MESH_CHAINS
    q, dt, acc = chain_major(torch, post.sampler, post.b, w_int, C, N_MESH_BURNIN, N_MESH_GATE, field=True)
    qoi_gates(torch, "refine-3 posterior (float64)", q, mu_q, var_q)
    rel = float((acc / (C * N_MESH_GATE) - mu).norm() / mu.norm())
    print(f"  refine-3 posterior field mean against A_post^-1 b: rel {rel:.5f} (gate {MESH_FIELD_GATE})")
    check(rel < MESH_FIELD_GATE, "the posterior's sample mean is off A_post^-1 b")

    w32 = w_int.to(torch.float32)
    q, _, _ = chain_major(torch, prior32.sampler, None, w32, C, N_MESH_BURNIN, N_MESH_GATE)
    qoi_gates(torch, "refine-3 prior (float32)", q, 0.0, var_prior)

    geo = build_mesh_sampler(torch, "refine-3 prior, geometric hierarchy", refinements=3, kappa=kappa,
                             hierarchy="geometric")
    check(geo.sampler.n_levels == 4 and torch.equal(geo.op.perm, post.op.perm),
          f"the geometric hierarchy has {geo.sampler.n_levels} levels")
    q, _, _ = chain_major(torch, geo.sampler, None, w_int, C, N_MESH_BURNIN, N_MESH_GATE)
    qoi_gates(torch, "refine-3 prior (geometric)", q, 0.0, var_prior)
    del geo

    pts, cells = mesh.read_gmsh(mesh.mesh_path("wrench"))
    for _ in range(2):
        pts, cells = mesh.refine(pts, cells)
    t0 = time.perf_counter()
    op2 = from_csr(mesh.matern_precision_mesh(pts, cells, kappa))
    patch = GraphPatchGibbsSampler.create(op2)
    torch.cuda.synchronize()
    print(f"  refine-2 graph patch Gibbs: {op2.n} DOFs, kmax {patch.kmax}, {patch.ncolors} colours "
          f"(set-up {time.perf_counter() - t0:.2f} s)")
    check(op2.n == 5682, f"refine-2 wrench: {op2.n} DOFs")
    w2 = region_qoi(pts, preset)
    w2_int = torch.as_tensor(w2[op2.perm.cpu().numpy()], device=op2.device)
    _, var2, _ = exact_qoi_law(torch, op2, w2_int)
    q, dt, _ = chain_major(torch, patch, None, w2_int, C, N_PATCH_BURNIN, N_PATCH_GATE)
    qoi_gates(torch, "refine-2 prior (graph patch Gibbs)", q, 0.0, var2)
    print(f"  graph patch Gibbs, {C} chains: {dt / N_PATCH_GATE * 1e3:.4f} ms/sweep")
    return w, mu_q, var_q


def ops_per_step(torch, fn, steps):
    """Torch (aten) ops a step of fn, which runs ``steps`` steps, counted by
    a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n / steps


def tau_report(torch, q):
    """(tau, valid, tau_sections) of QOI traces q ((n,) or (C, n)): the
    chain-mean tau (emcee window, c = 5) over the whole trace and over
    three half windows."""
    import numpy as np

    from parmgmc_tpu_torch.diagnostics.iact import iact

    q = q.double().cpu()
    m = q.shape[-1]
    taus, valid = iact(q)
    secs = []
    for lo, hi in ((0, m // 2), (m // 4, 3 * m // 4), (m // 2, m)):
        t, _ = iact(q[..., lo:hi])
        secs.append(round(float(np.maximum(t, 1.0).mean()), 4))
    return float(np.maximum(taus, 1.0).mean()), bool(np.all(valid)), secs


def mesh_device_report(torch, label, run, steps, dt):
    """Device time a step by kernel and the idle share (profiler over a
    window of ``steps`` steps), and the torch ops a step."""
    busy, per = device_ms(torch, run, 1)
    busy, per = busy / steps, {k: v / steps for k, v in per.items()}
    for name, t in sorted(per.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    device per step: {t:.4f} ms  {name}")
    nops = ops_per_step(torch, run, steps)
    idle = max(0.0, 1.0 - busy / (dt * 1e3))
    print(f"  {label}: device busy {busy:.4f} ms/step of {dt * 1e3:.4f} ms: idle share ~{idle:.3f}; "
          f"{nops:.0f} torch ops a step")


def phase_mesh_path(torch, post, prior32, prior4, w):
    """The refine-3 posterior with one chain (the reference's layout) and
    with 256 chain-major (the JAX package's production layout), the
    float32 prior with 256 chains, the refine-4 prior with one chain:
    ms/cycle, tau, tau_sections, ESS/sec or aggregate samples/s, device
    time and idle share, torch ops a step; no port kernel launched."""
    from parmgmc_tpu_torch import kernels

    kernels.reset_launch_counts()
    wt = torch.as_tensor(w, device=post.b.device)
    post.set_qoi(lambda x: x @ wt)
    post.sample(N_MESH_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = post.sample(N_MESH_1CHAIN)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / N_MESH_1CHAIN
    tau, valid, secs = tau_report(torch, q)
    print(f"  refine-3 posterior, 1 chain: {dt * 1e3:.4f} ms/cycle, tau {tau:.4f} (valid {valid}), "
          f"tau_sections {secs}, ESS/sec {1.0 / (tau * dt):.2f} over {N_MESH_1CHAIN} steps")
    mesh_device_report(torch, "refine-3 posterior, 1 chain", lambda: post.sample(8), 8, dt)

    for label, ms in (("refine-3 posterior (float64)", post), ("refine-3 prior (float32)", prior32)):
        ms.set_qoi(lambda x, wt=wt.to(ms.op.dtype): x @ wt)
        C = N_MESH_CHAINS
        ms.sample_chains(N_MESH_WARM, C)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = ms.sample_chains(N_MESH_PATH, C)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / N_MESH_PATH
        check(tuple(q.shape) == (C, N_MESH_PATH) and bool(torch.isfinite(q).all()), f"{label}: chain-major traces")
        tau, valid, secs = tau_report(torch, q)
        print(f"  {label}, {C} chains chain-major: {dt * 1e3:.4f} ms a step, {C / dt:.1f} samples/s aggregate, "
              f"mean tau {tau:.4f} (valid {valid}), tau_sections {secs}, {C / (tau * dt):.1f} ESS/sec aggregate")
        mesh_device_report(torch, f"{label}, {C} chains", lambda ms=ms: ms.sample_chains(4, C), 4, dt)

    prior4.set_qoi(lambda x: x.mean())
    prior4.sample(N_MESH_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = prior4.sample(N_MESH4_TIME)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / N_MESH4_TIME
    check(bool(torch.isfinite(q).all()), "refine-4 chain not finite")
    print(f"  refine-4 prior, 1 chain ({prior4.n} DOFs, {prior4.sampler.n_levels} levels): "
          f"{dt * 1e3:.4f} ms/cycle over {N_MESH4_TIME} steps")
    mesh_device_report(torch, "refine-4 prior, 1 chain", lambda: prior4.sample(4), 4, dt)
    counts = kernels.launch_counts(plain=False)
    check(not any(counts.values()), f"the mesh path launched a port kernel: {counts}")
    print("  the mesh path launched no port kernel (no TPU kernel on this path)")


def expect_v10(counts, steps, replayed=0):
    """The launch counts of ``steps`` V(1,0) chain steps at 256^3: one #1
    and one #2 a step, no other kernel; ``replayed`` of them replays of a
    captured step (a new capture's first step runs eagerly)."""
    return dict(dict.fromkeys(counts, 0), chain_down=steps, tail_down=steps,
                chain_step_graph=replayed)


def phase_matern(torch):
    """The structured Matérn façade at 256^3: describe, the QOI stream and
    its exact law, moments, a checkpoint, the solvers on b = 1, a VTK
    block; the façade and the launches of its sample run."""
    import shutil
    import tempfile

    from parmgmc_tpu_torch import io, kernels, solvers
    from parmgmc_tpu_torch.describe import describe
    from parmgmc_tpu_torch.diagnostics.iact import ess_per_sec, iact
    from parmgmc_tpu_torch.models.matern import MaternSampler
    from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd

    t0 = time.perf_counter()
    ms = MaternSampler((N_MAIN,) * 3, kappa=1.0, dtype=torch.float32, **POST_V10)
    torch.cuda.synchronize()
    check(ms.op.device.type == "cuda" and ms.b.device.type == "cuda",
          f"MaternSampler with no device argument is on {ms.op.device}")
    check(ms.sampler.deferred_eligible(), "the façade's sampler does not run the V(1,0) chain kernels")
    print(f"  MaternSampler set-up {time.perf_counter() - t0:.2f} s; describe():")
    print("\n".join("    " + line for line in describe(ms.sampler).splitlines()))
    N = N_MAIN**3
    ms.set_qoi(torch.mean)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = ms.sample(N_MATERN, burnin=N_MATERN_BURNIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = N_MATERN + N_MATERN_BURNIN
    counts = kernels.launch_counts(plain=False)
    check(counts == expect_v10(counts, steps, steps - 1),
          f"the façade's sample run launched {counts} in {steps} steps")
    q = q.double().cpu()
    tau, valid = iact(q)
    var_n = float(q.var()) * N
    se = math.sqrt(max(tau, 1.0) / (N_MATERN * N))
    print(f"  sample({N_MATERN}, burnin={N_MATERN_BURNIN}): {wall / steps * 1e3:.4f} ms a step, one #1 and one "
          f"#2 launch a step; var(QOI) N {var_n:.4f}, mean(QOI) {float(q.mean()):+.3e} ({float(q.mean()) / se:+.2f} SE), "
          f"tau {tau:.4f} (valid {valid}), ess_per_sec {ess_per_sec(q, wall):.2f} (over the call's {wall:.3f} s)")
    check(abs(var_n - 1.0) < MATERN_VAR_GATE, f"var(QOI) N = {var_n}, the exact law gives 1")
    check(abs(float(q.mean())) < 5 * se, f"mean(QOI) {float(q.mean())} is {float(q.mean()) / se:.2f} SE from 0")

    mean, var = ms.sample_mean_and_var(N_MATERN_MOMENTS)
    check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()), "sample_mean_and_var: not finite")
    pooled = float(mean.double().mean())
    se_m = math.sqrt(max(tau, 1.0) / (N_MATERN_MOMENTS * N))
    print(f"  sample_mean_and_var({N_MATERN_MOMENTS}): pooled mean {pooled:+.3e} ({pooled / se_m:+.2f} SE), "
          f"mean of var {float(var.double().mean()):.4e}")
    check(abs(pooled) < 5 * se_m, f"the pooled mean {pooled} is {pooled / se_m:.2f} SE from 0")

    tmp = tempfile.mkdtemp(prefix="smoke_", dir=os.path.join(os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "state.npz")
        io.save_chain_state(path, ms.state)
        st = io.load_chain_state(path)
        _, xa = ms.sampler.step(ms.state.key, ms.state.x, ms.b)
        _, xb = ms.sampler.step(st.key, st.x, ms.b)
        torch.cuda.synchronize()
        check(st.key == ms.state.key and torch.equal(xa, xb), "a step from the loaded checkpoint differs")
        print(f"  checkpoint of the {N_MAIN}^3 state ({os.path.getsize(path) / 2**20:.1f} MiB) and one step from "
              f"each copy: bit for bit ({time.perf_counter() - t0:.2f} s)")

        for dt in (torch.float64, torch.float32):
            op = shifted_laplace_fd((N_MAIN,) * 3, 1.0, dtype=dt)
            ones = torch.ones(op.grid_shape, dtype=dt, device=op.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # cg_solve(op, ones, tol=1e-5, maxiter=2000) is cg(...)[0]
            x, its = solvers.cg(op.apply, ones, tol=1e-5, maxiter=2000, M=solvers.sor_preconditioner(op))
            torch.cuda.synchronize()
            err = float(torch.linalg.vector_norm((x - 1.0).double()) / torch.linalg.vector_norm(ones.double()))
            print(f"  cg_solve, b = 1, {str(dt)[6:]}: {its} iterations in {time.perf_counter() - t0:.3f} s, "
                  f"relative 2-norm error {err:.3e} against A^-1 1 = 1")
            if dt == torch.float64:
                check(err < 1e-3, f"cg_solve in float64 is {err} from A^-1 1")
            del op, ones, x
        ones = torch.ones(ms.grid_shape, dtype=torch.float32, device=ms.op.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, res = solvers.richardson_solve(ms.op, ones, maxiter=N_RICHARDSON)
        res = res.cpu()
        secs = time.perf_counter() - t0
        check(bool(torch.isfinite(res).all()), "richardson_solve: residuals not finite")
        print(f"  richardson_solve, {N_RICHARDSON} iterations in {secs:.3f} s: residual 2-norms "
              f"{float(res[0]):.4f} .. {float(res[-1]):.4f} (b = 1 is the smooth mode Gauss-Seidel barely moves)")
        t0 = time.perf_counter()
        vtk = os.path.join(tmp, "mean.vtk")
        io.write_vtk_structured(vtk, {"mean": mean[:VTK_BLOCK, :VTK_BLOCK, :VTK_BLOCK]})
        print(f"  write_vtk_structured of a {VTK_BLOCK}^3 block of the mean: "
              f"{os.path.getsize(vtk) / 2**20:.1f} MiB in {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ms, counts


def phase_ex7(torch, ms):
    """The ex7 flow on the façade's sampler, the façade's many chains, a
    profiler trace of four steps; the launches of the two chain runs."""
    import shutil
    import tempfile

    import numpy as np

    from parmgmc_tpu_torch import kernels, profiling
    from parmgmc_tpu_torch.diagnostics.iact import iact
    from parmgmc_tpu_torch.diagnostics.rhat import ess_bulk, ess_tail, rhat_rank
    from parmgmc_tpu_torch.diagnostics.stats import sample_until_converged

    N = N_MAIN**3
    ones = torch.ones(ms.grid_shape, dtype=torch.float32, device=ms.op.device)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace, steps, rhat = sample_until_converged(
        ms.sampler, ones, torch.mean, n_chains=N_EX7_CHAINS, check_every=N_EX7_CHECK, method="rank",
        overdispersion=1e3, max_steps=N_EX7_MAX)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts(plain=False)
    check(counts == expect_v10(counts, N_EX7_CHAINS * steps, N_EX7_CHAINS * steps - 1),
          f"the ex7 flow launched {counts} in {N_EX7_CHAINS} x {steps} steps")
    check(rhat < 1.05 and trace.shape == (N_EX7_CHAINS, steps) and np.isfinite(trace).all(),
          f"sample_until_converged: rhat {rhat} after {steps} steps, trace {trace.shape}")
    tail = trace[:, steps // 2:]
    taus, _ = iact(tail)
    tau = float(np.maximum(taus, 1.0).mean())
    se = math.sqrt(tau / (tail.size * N))
    gap = float(tail.mean()) - 1.0
    print(f"  sample_until_converged: {steps} steps a chain x {N_EX7_CHAINS} chains in {wall:.3f} s "
          f"({wall / (steps * N_EX7_CHAINS) * 1e3:.4f} ms a chain step), rank R-hat {rhat:.4f}; step 0 QOI "
          f"{trace[:, 0].min():+.4f} .. {trace[:, 0].max():+.4f}; last half mean QOI {float(tail.mean()):.6f} "
          f"({gap / se:+.2f} SE from 1 / kappa^2 = 1, tau {tau:.4f})")
    print(f"  on the traces: rhat_rank {rhat_rank(trace):.4f}, ess_bulk {ess_bulk(trace):.1f}, "
          f"ess_tail {ess_tail(trace):.1f} of {trace.size} draws; one #1 and one #2 launch a chain step")
    check(abs(gap) < 5 * se, f"the ex7 flow's mean QOI is {gap / se:.2f} SE from 1")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    q = ms.sample_chains(N_FACADE_STEPS, n_chains=N_FACADE_CHAINS, burnin=N_MATERN_BURNIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c2 = kernels.launch_counts(plain=False)
    n_steps = N_FACADE_CHAINS * (N_FACADE_STEPS + N_MATERN_BURNIN)
    check(c2 == expect_v10(c2, n_steps, n_steps - 1), f"sample_chains launched {c2} in {n_steps} steps")
    check(tuple(q.shape) == (N_FACADE_CHAINS, N_FACADE_STEPS) and bool(torch.isfinite(q).all()),
          f"sample_chains gave {tuple(q.shape)}")
    var_n = (q.double().var(dim=1) * N).cpu()
    print(f"  sample_chains({N_FACADE_STEPS}, n_chains={N_FACADE_CHAINS}, burnin={N_MATERN_BURNIN}): "
          f"{wall:.3f} s, var(QOI) N by chain {[round(float(v), 4) for v in var_n]}")
    check(bool(((var_n - 1.0).abs() < MATERN_VAR_GATE).all()), f"a chain's var(QOI) N is off: {var_n}")
    for k in counts:
        counts[k] += c2[k]

    tmp = tempfile.mkdtemp(prefix="trace_", dir=os.path.join(os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        t0 = time.perf_counter()
        with profiling.trace(tmp):
            ms.sample(N_TRACE_STEPS)
        with open(os.path.join(tmp, "trace.json")) as f:
            text = f.read()
        names = [k for k in ("chain_march_kernel", "tail_grid_kernel") if k in text]
        print(f"  profiling.trace of {N_TRACE_STEPS} steps: {len(text) / 2**20:.2f} MiB, names {names} "
              f"({time.perf_counter() - t0:.2f} s)")
        check(len(names) == 2, "the profiler trace does not name both chain kernels")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts



def shard_block(torch, a, lo, hi, h):
    """Rows lo - h .. hi + h of a as a fresh tensor, zero rows beyond its
    ends: the halo-extended block of rows lo .. hi that the sharded path
    hands a kernel."""
    pad = a.new_zeros((h, *a.shape[1:]))
    return torch.cat([pad, a, pad])[lo : hi + 2 * h].contiguous()


def shard_checks(torch, label, x, b, blocks, calls):
    """Each (name, halo, fn, twin, args, kw, split) of ``calls`` on the
    halo-extended blocks ``blocks`` of (x, b) with row_offset / n0_global,
    noise on: the kept rows bit for bit the full-grid kernel's, the block
    against its twin on the same block (1e-4, the noisy tolerance of phase
    3).  ``split`` maps (outputs, h) to the kept parts."""
    n0 = x.shape[0]
    worst = {}
    for name, h, fn, twin, args, kw, keep in calls:
        full = fn(x, b, *args, **kw)
        for lo, hi in blocks:
            xe, be = shard_block(torch, x, lo, hi, h), shard_block(torch, b, lo, hi, h)
            off = dict(row_offset=lo - h, n0_global=n0)
            got = fn(xe, be, *args, **kw, **off)
            want = twin(xe, be, *args, **kw, **off)
            got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            rel = max(rel_err(a, w)[0] for a, w in zip(got_t, want_t))
            worst[name] = max(worst.get(name, 0.0), rel)
            check(rel <= 1e-4, f"{label} {name} rows {lo}..{hi}: kernel vs twin {rel:.3e}")
            for gk, fk in zip(keep(got, h), keep(full, 0, lo, hi)):
                check(torch.equal(gk, fk), f"{label} {name} rows {lo}..{hi}: kept rows differ "
                      "from the full-grid kernel")
    print(f"  {label}: blocks {blocks} bit for bit the full-grid kernels; worst vs twin "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))


def phase_shard_kernels(torch, dev):
    """Phase 28: the kernels of the sharded path on halo-extended blocks."""
    from parmgmc_tpu_torch.kernels import mg_sweep, rb_gibbs

    t_start = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(28)

    def sweep_keep(out, h, lo=None, hi=None):
        return (out[h:-h],) if lo is None else (out[lo:hi],)

    def chain_keep(out, h, lo=None, hi=None):
        if lo is None:
            return out[0][h:-h], out[1][h // 2 : -h // 2]
        return out[0][lo:hi], out[1][lo // 2 : hi // 2]

    def zero_fn(fn):  # #3 takes b alone
        return lambda x, b, *a, **k: fn(b, *a, **k)

    n = N_MAIN
    n_loc = n // SHARDS_MAX
    blocks = [(s * n_loc, (s + 1) * n_loc) for s in (0, 1, SHARDS_MAX - 1)]
    x, b = (torch.randn((n,) * 3, generator=g, device=dev) for _ in range(2))
    h2 = float((n - 1) ** 2)
    fine = ([-h2] * 6, 1.0, h2)
    coarse = ([-h2 / 2] * 6, 8.0, h2 / 2)  # level 1 of the aggregate hierarchy
    shard_checks(torch, f"{n}^3 on {SHARDS_MAX} shards", x, b, blocks, [
        ("#7", 2, rb_gibbs.fused_rb_gibbs_sweep_fd, rb_gibbs.fused_rb_gibbs_sweep_fd_reference,
         (*fine, 1.0, 3, 5), dict(sweep="forward"), sweep_keep),
        ("#1", 4, mg_sweep.fused_chain_down_fd, mg_sweep.fused_chain_down_fd_reference,
         (*fine, 1.0, 7, 9), {}, chain_keep),
    ])
    xc, bc = x[: n // 2, : n // 2, : n // 2].contiguous(), b[: n // 2, : n // 2, : n // 2].contiguous()
    n_loc = n // 2 // SHARDS_MAX
    shard_checks(torch, f"{n // 2}^3 (level 1) on {SHARDS_MAX} shards", xc, bc,
                 [(s * n_loc, (s + 1) * n_loc) for s in (0, 1, SHARDS_MAX - 1)], [
        ("#3", 2, zero_fn(mg_sweep.fused_zero_gibbs_restrict_fd),
         zero_fn(mg_sweep.fused_zero_gibbs_restrict_fd_reference), (*coarse, 1.0, 7, 9), {},
         lambda out, h, lo=None, hi=None: ((out[0][h:-h], out[1][1:-1]) if lo is None
                                            else (out[0][lo:hi], out[1][lo // 2 : hi // 2]))),
    ])
    del x, b, xc, bc
    # the large-plane routes (#8, #9; #4, #5) on 16-row shards of phase 14's grid
    shape = (32, N_BIG, N_BIG)
    x, b = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    h2 = float((N_BIG - 1) ** 2)
    shard_checks(torch, f"{shape} on 2 shards", x, b, [(0, 16), (16, 32)], [
        ("#8", 2, lambda x, b, *a, **k: rb_gibbs.fused_rb_gibbs_sweep_2d(x, b, None, *a, **k),
         lambda x, b, *a, staged=True, **k: rb_gibbs.fused_rb_gibbs_sweep_2d_reference(
             x, b, None, *a, **k),
         ([-h2] * 6, 1.0, 3, 5), dict(fd_params=(1.0, h2), staged=False, sweep="backward"),
         sweep_keep),
        ("#9", 2, rb_gibbs.fused_rb_gibbs_sweep_2d_staged,
         rb_gibbs.fused_rb_gibbs_sweep_2d_staged_reference, ([-h2] * 6, 1.0, 3, 5),
         dict(fd_params=(1.0, h2)), sweep_keep),
        ("#4", 4, mg_sweep.fused_chain_down_2d, mg_sweep.fused_chain_down_2d_reference,
         ([-h2] * 6, 1.0, h2, 1.0, 7, 9), {}, chain_keep),
        ("#5", 4, mg_sweep.fused_chain_down_2d_staged, mg_sweep.fused_chain_down_2d_staged_reference,
         ([-h2] * 6, 1.0, h2, 1.0, 7, 9), {}, chain_keep),
    ])
    print(f"  phase 28 wall {time.perf_counter() - t_start:.1f} s")


def slot_devices(torch, n):
    """S slots: distinct cards where the machine has S, else S slots on cuda:0."""
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * n


def zero_tree(torch, shapes, dev, dtype=None):
    if isinstance(shapes, tuple):
        return torch.zeros(shapes, device=dev, dtype=dtype)
    if isinstance(shapes, dict):
        return {k: zero_tree(torch, v, dev, dtype) for k, v in shapes.items()}
    return [zero_tree(torch, v, dev, dtype) for v in shapes]


def sharded_qoi_chain(torch, step, xs, b, n_burn, n):
    """(xs, q): n steps of a sharded chain after n_burn, q the mean of
    each state (block sums added on the device, read once at the end)."""
    key = 3
    for _ in range(n_burn):
        key, xs = step(key, xs, b)
    npts = sum(x.numel() for x in xs)
    qs = []
    for _ in range(n):
        key, xs = step(key, xs, b)
        qs.append(sum(x.sum().to(xs[0].device) for x in xs) / npts)
    return xs, torch.stack(qs).double().cpu()


def phase_sharded_path(torch, dev, smi):
    """Phase 29: make_sharded_mgmc_step at 256^3 on 1, 2 and 4 slots."""
    import numpy as np

    from parmgmc_tpu_torch import kernels
    from parmgmc_tpu_torch.chain import init_chain, sample_chain
    from parmgmc_tpu_torch.diagnostics.iact import iact
    from parmgmc_tpu_torch.kernels import mg_sweep, rb_gibbs
    from parmgmc_tpu_torch.models.obs import make_posterior_operator
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.parallel.fused import make_sharded_mgmc_step
    from parmgmc_tpu_torch.parallel.mesh import make_mesh, shard_array, unshard
    from parmgmc_tpu_torch.parallel.sharded import make_sharded_gibbs_step
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    t_start = time.perf_counter()
    n = N_MAIN
    npts = n**3
    op = gmrf_3d(n, kappa=1.0)
    smp = MGMCSampler.create(op, **POST_V10)
    g = torch.Generator(device=dev).manual_seed(29)
    x0 = torch.randn((n,) * 3, generator=g, device=dev)
    ref0 = smp.step_with_noise(x0, None, zero_tree(torch, smp.noise_shapes(), dev))

    def no_twin(*a, **k):
        raise SmokeFailure("a CUDA shard ran a twin")

    twins = [mock.patch.object(mg_sweep, name, no_twin) for name in (
        "fused_chain_down_fd_reference", "fused_chain_down_2d_reference",
        "fused_zero_gibbs_restrict_fd_reference")] + [
        mock.patch.object(rb_gibbs, "fused_rb_gibbs_sweep_fd_reference", no_twin)]

    def timed(run, steps):
        run(8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    # the unsharded keyed step (sample_chain: #1 and #2 a step)
    holder = [init_chain(smp, 0)]

    def plain(k):
        holder[0], _ = sample_chain(smp, holder[0], None, k)

    ms_plain = timed(plain, N_SHARD_TIME)
    busy_plain = queued_ms(torch, lambda: smp.step(1, holder[0].x, None), 2)
    del holder
    print(f"  unsharded MGMCSampler.step: {ms_plain:.4f} ms/step, device {busy_plain:.4f} ms/step "
          f"({smi})")

    bits, counts = None, {}
    for S in SHARD_COUNTS:
        mesh = make_mesh((S,), devices=slot_devices(torch, S))
        step = make_sharded_mgmc_step(smp, mesh)
        with contextlib.ExitStack() as stack:
            for t in twins:
                stack.enter_context(t)
            kernels.reset_launch_counts()
            key, xs = 5, shard_array(x0, mesh)
            for _ in range(3):
                key, xs = step(key, xs, None)
            c = kernels.launch_counts(plain=False)
            want = dict(dict.fromkeys(c, 0), chain_down=3 * S, zero_restrict=3 * S)
            check(c == want, f"{S} shards: 3 steps launched {c}, expected {want}")
            out = unshard(xs, device=dev)
            check(bool(torch.isfinite(out).all()), f"{S} shards: state not finite")
            if bits is None:
                bits = out
            check(torch.equal(out, bits), f"{S} shards: the noise-on bits differ from 1 shard's")
            _, off = make_sharded_mgmc_step(smp, mesh, with_noise=False)(5, shard_array(x0, mesh), None)
            rel, _ = rel_err(unshard(off, device=dev), ref0)
            check(rel < 1e-5, f"{S} shards, noise off, against step_with_noise: {rel:.3e}")
            carry = [shard_array(x0, mesh)]

            def run(k):
                key = 1
                for _ in range(k):
                    key, carry[0] = step(key, carry[0], None)

            ms = timed(run, N_SHARD_TIME)
            busy = queued_ms(torch, lambda: step(1, carry[0], None), 2)
            print(f"  {S} shard(s) on {sorted(set(map(str, mesh.slots())))}: {ms:.4f} ms/step "
                  f"({ms / ms_plain:.3f} x the unsharded step), device {busy:.4f} ms/step, idle share "
                  f"~{max(0.0, 1.0 - busy / ms):.3f}; noise off vs step_with_noise {rel:.2e}; "
                  f"launches a step {c['chain_down'] // 3} #1, {c['zero_restrict'] // 3} #3")
            if S == SHARDS_MAX:
                kernels.reset_launch_counts()
                xs, q = sharded_qoi_chain(torch, step, shard_array(x0, mesh), None, 16, N_SHARD_QOI)
                counts = kernels.launch_counts(plain=False)
                steps = 16 + N_SHARD_QOI
                want = dict(dict.fromkeys(counts, 0), chain_down=S * steps, zero_restrict=S * steps)
                check(counts == want, f"the {S}-shard chain launched {counts}, expected {want}")
                var_ratio = q.var().item() * npts
                tau, valid = iact(q)
                zmean = q.mean().item() * math.sqrt(npts * N_SHARD_QOI)
                print(f"  {S}-shard chain, {N_SHARD_QOI} steps: var(QOI) N {var_ratio:.4f} (exact 1), "
                      f"mean / SE {zmean:.3f}, tau {tau:.4f} (valid {valid})")
                check(abs(var_ratio - 1.0) < SHARD_VAR_GATE, "sharded QOI variance off the prior law")
                check(abs(zmean) < 5.0 * math.sqrt(max(tau, 1.0)), "sharded QOI mean off zero")
        del step, carry
    del smp, ref0
    torch.cuda.empty_cache()

    # the 256^3 posterior (phase 20's problem) on 4 slots
    k = 5
    rng = np.random.default_rng(0)
    coords = 0.15 + 0.7 * rng.random((k, 3))
    obsvals = rng.standard_normal(k)
    post, f = make_posterior_operator(gmrf_3d(n, kappa=1.0), 0.01, coords, np.full(k, 0.12), obsvals)
    t0 = time.perf_counter()
    smp = MGMCSampler.create(post, **POST_V10)
    t_create = time.perf_counter() - t0
    mesh = make_mesh((SHARDS_MAX,), devices=slot_devices(torch, SHARDS_MAX))
    fs = shard_array(f, mesh)
    _, off = make_sharded_mgmc_step(smp, mesh, with_noise=False)(5, shard_array(x0, mesh), fs)
    ref = smp.step_with_noise(x0, f, zero_tree(torch, smp.noise_shapes(), dev))
    rel, _ = rel_err(unshard(off, device=dev), ref)
    check(rel < 5e-5, f"sharded posterior, noise off, against step_with_noise: {rel:.3e}")
    step = make_sharded_mgmc_step(smp, mesh)
    with contextlib.ExitStack() as stack:
        for t in twins:
            stack.enter_context(t)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        xs, q = sharded_qoi_chain(torch, step, shard_array(x0, mesh), fs, 16, N_SHARD_QOI)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / (16 + N_SHARD_QOI) * 1e3
        c = kernels.launch_counts(plain=False)
    steps = 16 + N_SHARD_QOI
    want = dict(dict.fromkeys(c, 0), chain_down=SHARDS_MAX * steps)
    check(c == want, f"the sharded posterior launched {c}, expected {want}")
    counts["chain_down"] += c["chain_down"]
    m, v = posterior_qoi_law(torch, post, obsvals)
    tau, valid = iact(q)
    var_ratio = q.var().item() / v
    zmean = (q.mean().item() - m) / math.sqrt(v / N_SHARD_QOI)
    print(f"  {SHARDS_MAX}-shard posterior (set-up {t_create:.2f} s): {dt:.4f} ms/step with the QOI; "
          f"noise off vs step_with_noise {rel:.2e}; QOI var / exact {var_ratio:.4f}, mean / SE off "
          f"{zmean:.3f}, tau {tau:.4f} (valid {valid})")
    check(abs(var_ratio - 1.0) < SHARD_VAR_GATE, "sharded posterior QOI variance off its exact law")
    check(abs(zmean) < 5.0 * math.sqrt(max(tau, 1.0)), "sharded posterior QOI mean off its exact law")
    check(all(bool(torch.isfinite(x).all()) for x in xs), "sharded posterior state not finite")
    del smp, post, f, fs, xs, step, ref, off
    torch.cuda.empty_cache()

    # the plain sharded Gibbs step, each halo mode, one step from x0
    outs = {}
    for mode in ("exact", "frozen"):
        gstep = make_sharded_gibbs_step(op, mesh, omega=1.0, halo_mode=mode)
        _, xs = gstep(9, shard_array(x0, mesh), None)
        outs[mode] = unshard(xs, device=dev)
    interior = torch.ones(n, dtype=torch.bool, device=dev)
    n_loc = n // SHARDS_MAX
    for s in range(SHARDS_MAX):
        for d in range(2):  # the frozen halo reaches two rows in from a block edge
            interior[s * n_loc + d] = False
            interior[s * n_loc + n_loc - 1 - d] = False
    d_int = (outs["frozen"][interior] - outs["exact"][interior]).abs().max().item()
    d_all = (outs["frozen"] - outs["exact"]).abs().max().item()
    print(f"  sharded Gibbs step, {SHARDS_MAX} shards: frozen vs exact interior {d_int:.2e}, "
          f"at the block edges {d_all:.2e}")
    check(bool(torch.isfinite(outs["frozen"]).all()) and d_int < 1e-5,
          "the frozen-halo step's interiors differ from the exact step's")
    print(f"  phase 29 wall {time.perf_counter() - t_start:.1f} s")
    return counts

def busy_text(busy, ms):
    """The device busy time a step and the idle share, or "not measured"."""
    if busy <= 0:
        return "device busy not measured (the profiler saw no device time)"
    return f"device busy {busy:.4f} ms, idle share ~{max(0.0, 1.0 - busy / ms):.3f}"


def median_ms(torch, run, steps, windows=3):
    """Median wall ms a step of ``run(steps)`` over ``windows`` windows."""
    ts = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) / steps * 1e3)
    return sorted(ts)[len(ts) // 2]


def phase_graph_sharded(torch, dev, smi, post, prior32, prior4, w, mu_q, var_q):
    """Phase 30: the row-partitioned wrench (parallel.graph_sharded) on 1, 2
    and 4 slots: partitions, the deterministic step against the unsharded
    one, the ghost modes, the 256-chain posterior gates, timings."""
    from parmgmc_tpu_torch import kernels
    from parmgmc_tpu_torch.parallel.graph_sharded import make_sharded_graph_mgmc_step
    from parmgmc_tpu_torch.parallel.mesh import make_mesh, psum

    t_start = time.perf_counter()
    kernels.reset_launch_counts()
    g = torch.Generator(device=dev).manual_seed(30)
    cases = (("refine-3 posterior (float64)", post, 1e-10), ("refine-3 prior (float32)", prior32, 5e-5),
             ("refine-4 prior (float64)", prior4, 1e-10))
    for label, ms, tol in cases:
        smp, dt = ms.sampler, ms.op.dtype
        x = torch.randn(ms.n, generator=g, dtype=torch.float64, device=dev).to(dt)
        ref = smp.step_with_noise(x, ms.b, zero_tree(torch, smp.noise_shapes(), dev, dt))
        outs = {}
        for S in SHARD_COUNTS:
            mesh = make_mesh((S,), devices=slot_devices(torch, S))
            modes = ("neighbor", "allgather") if S == SHARDS_MAX else ("neighbor",)
            for mode in modes:
                t0 = time.perf_counter()
                step, spec, lay = make_sharded_graph_mgmc_step(smp, mesh, coords=ms.points, with_noise=False,
                                                               ghost_mode=mode)
                t_set = time.perf_counter() - t0
                _, out = step(0, lay.shard(x), lay.shard(ms.b))
                outs[(S, mode)] = lay.unshard(out, device=dev)
                rel, _ = rel_err(outs[(S, mode)], ref)
                print(f"  {label}, {S} slot(s), {mode}: L {spec.n_local} rows a slot, {spec.ncolors} colours, "
                      f"nbr_shifts {spec.nbr_shifts}, ghost rows received {spec.ghost_rows_received}; "
                      f"partition {t_set:.2f} s; noise off vs step_with_noise {rel:.2e} (gate {tol:g})")
                check(rel < tol, f"{label} on {S} slots ({mode}): the sharded step is off the unsharded one")
        agree, _ = rel_err(outs[(SHARDS_MAX, "allgather")], outs[(SHARDS_MAX, "neighbor")])
        print(f"  {label}: neighbor vs allgather at {SHARDS_MAX} slots {agree:.2e}")
        check(agree < 1e-12, f"{label}: the ghost modes disagree")

    # the refine-3 posterior, 256 chains chain-major on 4 slots: phase 24's gates
    smp, C, S = post.sampler, N_MESH_CHAINS, SHARDS_MAX
    mesh = make_mesh((S,), devices=slot_devices(torch, S))
    step, spec, lay = make_sharded_graph_mgmc_step(smp, mesh, coords=post.points, n_chains=C)
    w_int = torch.as_tensor(w[post.op.perm.cpu().numpy()], device=dev)
    w_loc, bs = lay.shard(w_int), lay.shard(post.b)
    xs = [torch.zeros((spec.n_local, C), dtype=post.op.dtype, device=d) for d in spec.devices]
    key = 5
    for _ in range(N_MESH_BURNIN):
        key, xs = step(key, xs, bs)
    qs = []
    for _ in range(N_MESH_GATE):
        key, xs = step(key, xs, bs)
        qs.append(psum([wl @ x for wl, x in zip(w_loc, xs)])[0])
    qoi_gates(torch, f"refine-3 posterior on {S} slots, {C} chains", torch.stack(qs).T, mu_q, var_q)

    # ms a step (medians of three windows of N_SHARD_GRAPH steps), busy, idle
    x0 = torch.zeros((post.n, C), dtype=post.op.dtype, device=dev)
    hold = [x0]

    def plain(k):
        key = 1
        for _ in range(k):
            key, hold[0] = smp.step(key, hold[0], post.b)

    ms_plain = median_ms(torch, plain, N_SHARD_GRAPH)
    busy, _ = profiled_ms(torch, lambda: smp.step(1, hold[0], post.b), 2)
    print(f"  refine-3 posterior, {C} chains, unsharded step: {ms_plain:.4f} ms a step, "
          f"{busy_text(busy, ms_plain)} ({smi})")
    for S in SHARD_COUNTS:
        mesh = make_mesh((S,), devices=slot_devices(torch, S))
        step, spec, lay = make_sharded_graph_mgmc_step(smp, mesh, coords=post.points, n_chains=C)
        carry = [lay.shard(x0), lay.shard(post.b)]

        def run(k):
            key = 1
            for _ in range(k):
                key, carry[0] = step(key, carry[0], carry[1])

        ms = median_ms(torch, run, N_SHARD_GRAPH)
        busy, _ = profiled_ms(torch, lambda: step(1, carry[0], carry[1]), 2)
        check(all(bool(torch.isfinite(v).all()) for v in carry[0]), f"{S} slots: the chains are not finite")
        print(f"  refine-3 posterior, {C} chains, {S} slot(s): {ms:.4f} ms a step ({ms / ms_plain:.3f} x the "
              f"unsharded step), {busy_text(busy, ms)}")
    counts = kernels.launch_counts(plain=False)
    check(not any(counts.values()), f"the sharded wrench launched a port kernel: {counts}")
    print(f"  phase 30 wall {time.perf_counter() - t_start:.1f} s")


def phase_shard_sampler(torch, dev, smi):
    """Phase 31: shard_sampler on ex13's structured weak-scaling
    configuration at --base 128 on 1, 2 and 4 slots, and one step of the
    README quick start at 256^3 on 4 slots."""
    from parmgmc_tpu_torch import kernels
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
    from parmgmc_tpu_torch.parallel.mesh import make_mesh, shard_sampler
    from parmgmc_tpu_torch.samplers.gibbs import _draw
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
    from parmgmc_tpu_torch.samplers.registry import lax_variant

    t_start = time.perf_counter()
    kernels.reset_launch_counts()
    g = torch.Generator(device=dev).manual_seed(31)

    def parity(label, smp, S, windows):
        mesh = make_mesh((S,), ("x",), devices=slot_devices(torch, S))
        sh, lay = shard_sampler(smp, mesh, min_local=4, grid_axes=("x", None, None))
        split = sum(bool(lv.split) for lv in sh.levels)
        x = torch.randn(smp.grid_shape, generator=g, device=dev)
        plain = lax_variant(smp)
        if windows:
            nz = _draw(3, smp.noise_shapes(), torch.float32, dev)
            ref = smp.step_with_noise(x, None, nz)
            rel, _ = rel_err(lay.unshard(sh.step_with_noise(lay.shard(x), None, nz), device=dev), ref)
            check(rel < 1e-5, f"{label}: step_with_noise on {S} slots is off the unsharded one: {rel:.3e}")
        k1, ref = plain.step(7, x, None)
        k2, out = sh.step(7, lay.shard(x), None)
        out = lay.unshard(out, device=dev)
        same = k1 == k2 and torch.equal(out, ref)
        krel, _ = rel_err(out, ref)
        text = (f"  {label}, {S} slot(s): {split} of {smp.n_levels} levels split, keyed step vs unsharded "
                f"{'bit for bit' if same else f'{krel:.2e}'}")
        if windows:
            text += f", step_with_noise vs unsharded {rel:.2e}"
        print(text)
        check(krel < 1e-5, f"{label}: the keyed step on {S} slots is off the unsharded one")
        if not windows:
            return same
        check(same, f"{label}: the keyed step on {S} slots is not the unsharded one bit for bit")
        hold = [x, lay.shard(x)]

        def run_plain(k):
            key = 1
            for _ in range(k):
                key, hold[0] = plain.step(key, hold[0], None)

        def run(k):
            key = 1
            for _ in range(k):
                key, hold[1] = sh.step(key, hold[1], None)

        ms_plain = median_ms(torch, run_plain, N_SHARD_SAMPLER, windows)
        ms = median_ms(torch, run, N_SHARD_SAMPLER, windows)
        busy_plain, _ = profiled_ms(torch, lambda: plain.step(1, hold[0], None), 1)
        busy, _ = profiled_ms(torch, lambda: sh.step(1, hold[1], None), 1)
        print(f"    {ms:.4f} ms a step ({ms / ms_plain:.3f} x the unsharded plain step's {ms_plain:.4f}), "
              f"{busy_text(busy, ms)}; unsharded {busy_text(busy_plain, ms_plain)}; {smi}")
        return same

    for S in SHARD_COUNTS:
        t0 = time.perf_counter()
        op = shifted_laplace_fd((SHARD_BASE * S, SHARD_BASE, SHARD_BASE), 1.0)
        smp = MGMCSampler.create(op, n_pre=1, n_post=1, coarsest_size=128)
        print(f"  ex13 --base {SHARD_BASE}, {S} slot(s): grid {op.grid_shape} ({op.n} DOFs), levels "
              f"{[tuple(o.grid_shape) for o in smp.ops]} (set-up {time.perf_counter() - t0:.2f} s)")
        parity(f"ex13 V(1,1) {op.grid_shape}", smp, S, windows=SHARD_WINDOWS)
        del smp, op
    torch.cuda.empty_cache()
    smp = MGMCSampler.create(gmrf_3d(N_MAIN), n_pre=2, n_post=2)
    parity(f"README quick start {N_MAIN}^3 V(2,2)", smp, SHARDS_MAX, windows=0)
    del smp
    torch.cuda.empty_cache()
    counts = kernels.launch_counts(plain=False)
    check(not any(counts.values()), f"shard_sampler launched a port kernel: {counts}")
    print(f"  phase 31 wall {time.perf_counter() - t_start:.1f} s")


def phase_dryrun(torch):
    """Phase 32: dryrun_multichip on 4 slots of cuda:0; returns its kernel
    launches."""
    from parmgmc_tpu_torch import kernels
    from parmgmc_tpu_torch.parallel.dryrun import dryrun_multichip

    t_start = time.perf_counter()
    kernels.reset_launch_counts()
    dryrun_multichip(SHARDS_MAX, devices=["cuda:0"] * SHARDS_MAX)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"  launches {dict((k, v) for k, v in counts.items() if v)}; phase 32 wall "
          f"{time.perf_counter() - t_start:.1f} s")
    return counts


def phase_examples(torch):
    """Phase 33: each ported example's main on the card at EXAMPLE_RUNS' cut
    counts, its own assert kept; no port kernel launched."""
    import tempfile

    from parmgmc_tpu_torch import kernels
    from parmgmc_tpu_torch.examples import ex2_matern_iact

    t_start = time.perf_counter()
    before = kernels.launch_counts(plain=False)
    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(ex2_matern_iact, "N_MEAN_VAR", N_EX2_MEAN_VAR):
        for label, name, argv, cut in EXAMPLE_RUNS:
            argv = [a.replace("{tmp}", tmp) for a in argv]
            print(f"  -- {label}: {cut}; python -m parmgmc_tpu_torch.examples.{name} {' '.join(argv)}")
            mod = __import__(f"parmgmc_tpu_torch.examples.{name}", fromlist=["main"])
            t0 = time.perf_counter()
            out = mod.main(argv)
            torch.cuda.synchronize()
            if name == "make_meshes":
                for geo, rec in out.items():
                    with open(rec["path"], "rb") as a, open(os.path.join("data", f"{geo}.msh"), "rb") as b:
                        check(a.read() == b.read(), f"make_meshes wrote {geo}.msh unlike data/{geo}.msh")
                print("  make_meshes: all four files byte for byte data/*.msh")
            print(f"  {label} passed its assert in {time.perf_counter() - t0:.2f} s")
    after = kernels.launch_counts(plain=False)
    check(after == before, f"the examples launched port kernels: {before} -> {after}")
    print(f"  launch counters unchanged across the phase; phase 33 wall {time.perf_counter() - t_start:.1f} s")


def main():
    t_start = time.perf_counter()
    # the profiler (phases 3 on) leaves CUPTI's callbacks in place unless
    # told to tear them down, and every later launch then pays for them:
    # the host-bound chains of the later phases ran ~20 % slower
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from parmgmc_tpu_torch import kernels
    except ImportError as e:
        print(f"FAIL: the parmgmc_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    clock = [t_start]

    def phase(title):
        now = time.perf_counter()
        print(f"  ({now - clock[0]:.1f} s)")
        clock[0] = now
        print(f"== {title}")

    phase("1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase("2. build")
    secs = kernels.build(verbose=True)
    kernels.lib()
    print(f"  nvcc build: {secs:.2f} s")
    print(f"  1 GiB device copy: {copy_rate(torch, dev) / 1e12:.4f} TB/s (read + write)")

    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    t0 = time.perf_counter()
    op = gmrf_3d(N_MAIN, kappa=1.0)
    main_smp = MGMCSampler.create(op, n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate")
    v22_smp = MGMCSampler.create(op, n_pre=2, n_post=2, coarsest_size=128, coarsening="aggregate")
    check(op.device.type == "cuda", f"gmrf_3d with no device argument is on {op.device}")
    print(f"  main sampler levels {[o.grid_shape for o in main_smp.ops]} "
          f"(setup {time.perf_counter() - t0:.2f} s)")

    phase("3. kernels against their twins")
    rec = phase_kernels(torch, dev, main_smp, v22_smp)
    phase("4. moments gate")
    smp, b = phase_moments(torch, dev)
    phase("5. deferred chain")
    phase_deferred(torch, smp, b, main_smp)
    phase("6. main path")

    check(all(main_smp._tail_fused_eligible(l) for l in range(1, main_smp.n_levels - 1)),
          "the 256^3 hierarchy's levels below 0 do not all take the tail kernel")
    counts = phase_main(torch, dev, main_smp,
                        want=lambda steps: expect_v10(kernels.launch_counts(plain=False), steps, steps))
    phase("7. moments gates: V(2,2) and Gibbs")
    gates = phase_moments_general(torch, dev, b)
    phase("8. V(2,2) path")
    counts.update({k: v for k, v in phase_v22(torch, v22_smp, {"rb_gibbs_fd": 20})[0].items() if k == "rb_gibbs_fd"})
    phase("9. Gibbs chains")
    cases = [(mode, sweep, counter) for mode, counter in (("FD", "rb_gibbs_fd"), ("streamed", "rb_gibbs"))
             for sweep in ("forward", "symmetric")]
    counts.update({k: v for k, v in phase_gibbs(torch, op, cases, N_GIBBS_TIME).items() if k == "rb_gibbs"})
    del op, main_smp, v22_smp

    from parmgmc_tpu_torch.models.problems import squared_shifted_laplace_fd
    from parmgmc_tpu_torch.samplers.patch_gibbs import PatchGibbsSampler

    t0 = time.perf_counter()
    patch_smps = [PatchGibbsSampler.create(squared_shifted_laplace_fd((n,) * 3, 1.0)) for n in (128, N_MAIN)]
    for s in patch_smps:
        check(s.sq_fd_params is not None, f"no squared FD operator detected at {s.grid_shape}")
        print(f"  patch sampler {s.grid_shape}: detected (kappa2, hinv2) = {s.sq_fd_params} "
              f"(exact 1, {(s.grid_shape[0] - 1) ** 2}); {len(s.base.offsets)} offsets, "
              f"{sum(c.ndim > 0 for c in s.base.coeffs)} coefficient fields")
    print(f"  patch set-up {time.perf_counter() - t0:.2f} s")
    phase("10. patch kernels against their twin")
    rec.update(phase_patch_kernels(torch, dev, patch_smps))
    phase("11. patch moments gate")
    phase_patch_moments(torch, dev)
    phase("12. patch path")
    counts.update(phase_patch_path(torch, patch_smps))
    del patch_smps

    t0 = time.perf_counter()
    big_op = gmrf_3d(N_BIG, kappa=1.0)
    big_smp = MGMCSampler.create(big_op, n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate")
    big_levels = [tuple(o.grid_shape) for o in big_smp.ops]
    print(f"  {N_BIG}^3 sampler levels {big_levels} (setup {time.perf_counter() - t0:.2f} s)")
    check(big_smp._chain_level0_2d() and not any(big_smp._tail_fused_eligible(l) for l in range(1, len(big_levels))),
          f"the {N_BIG}^3 hierarchy does not route level 0 to the large-plane kernels and the rest to #3")
    phase("13. large-plane chain kernels against their twins")
    rec.update(phase_march_kernels(torch, dev, big_smp))
    phase("14. large-plane moments gate")
    counts.update({k: v for k, v in phase_moments_2d(torch, dev).items() if k == "chain_2d"})
    phase(f"15. {N_BIG}^3 main path")
    n_smooth = len(big_levels) - 2  # smoothed levels below 0

    def want_big(steps):
        w = dict.fromkeys(kernels.launch_counts(plain=False), 0)
        w.update(chain_2d_staged=steps, zero_restrict=n_smooth * steps, chain_step_graph=steps)
        return w

    c = phase_main(torch, dev, big_smp, N_BIG, N_BIG_TIME, N_BIG_IACT, want=want_big, twin=False)
    counts.update({k: c[k] for k in ("chain_2d_staged", "zero_restrict")})
    del big_smp

    big22 = MGMCSampler.create(big_op, n_pre=2, n_post=2, coarsest_size=128, coarsening="aggregate")
    check([tuple(o.grid_shape) for o in big22.ops] == big_levels, "the 768^3 V(2,2) hierarchy differs")
    phase("16. large-plane sweep kernels against their twins")
    rec.update(phase_sweep2d_kernels(torch, dev, big22))
    phase("17. large-plane sweep moments gates")
    phase_sweep2d_moments(torch, dev, b, gates)
    phase(f"18. {N_BIG}^3 V(2,2) and Gibbs chains")
    # level 0 past _PLANE_LIMIT on #9, levels 384^3 .. 12^3 on #7: 4 sweeps each
    c, _ = phase_v22(torch, big22, {"rb_gibbs_2d_staged": 4, "rb_gibbs_fd": 4 * (len(big_levels) - 2)},
                     n_time=N_BIG_V22_TIME, n_iact=N_BIG_V22_IACT, n_warm=8, twin=False)
    cases = (("FD", "forward", "rb_gibbs_2d_staged"), ("FD", "symmetric", "rb_gibbs_2d_staged"),
             ("streamed", "forward", "rb_gibbs_2d"))
    g = phase_gibbs(torch, big_op, cases, N_BIG_GIBBS)
    counts.update(rb_gibbs_2d_staged=c["rb_gibbs_2d_staged"] + g["rb_gibbs_2d_staged"], rb_gibbs_2d=g["rb_gibbs_2d"])
    del big22, big_op
    torch.cuda.empty_cache()
    phase("19. posterior gates")
    phase_posterior_gates(torch, dev)
    phase(f"20. {N_MAIN}^3 posterior path")
    phase_posterior_path(torch, dev)
    phase("21. linear hierarchy")
    phase_linear(torch, dev)
    phase(f"22. {N_MAIN}^3 default V(2,2) path")
    counts["rb_gibbs_fd"] += phase_linear_path(torch, dev)["rb_gibbs_fd"]
    torch.cuda.empty_cache()
    phase("23. unstructured mesh set-up")
    preset, post, prior32, prior4 = phase_mesh_setup(torch)
    phase("24. unstructured mesh gates")
    w, mu_q, var_q = phase_mesh_gates(torch, preset, post, prior32)
    phase("25. unstructured mesh path")
    phase_mesh_path(torch, post, prior32, prior4, w)
    torch.cuda.empty_cache()  # the three mesh samplers stay for phase 30
    phase(f"26. structured Matérn façade, {N_MAIN}^3")
    ms, c26 = phase_matern(torch)
    phase(f"27. ex7 flow, {N_MAIN}^3")
    c27 = phase_ex7(torch, ms)
    del ms
    for k in ("chain_down", "tail_down"):
        counts[k] += c26[k] + c27[k]
    torch.cuda.empty_cache()
    phase(f"28. the kernels on shards, {N_MAIN}^3 and (32, {N_BIG}, {N_BIG})")
    phase_shard_kernels(torch, dev)
    phase(f"29. the sharded path, {N_MAIN}^3 on {', '.join(map(str, SHARD_COUNTS))} shards")
    c29 = phase_sharded_path(torch, dev, smi)
    for k in ("chain_down", "zero_restrict"):
        counts[k] += c29[k]
    phase(f"30. the sharded wrench on {', '.join(map(str, SHARD_COUNTS))} slots")
    phase_graph_sharded(torch, dev, smi, post, prior32, prior4, w, mu_q, var_q)
    del post, prior32, prior4
    torch.cuda.empty_cache()
    phase(f"31. shard_sampler, ex13 --base {SHARD_BASE} on {', '.join(map(str, SHARD_COUNTS))} slots")
    phase_shard_sampler(torch, dev, smi)
    phase(f"32. the dry run on {SHARDS_MAX} slots")
    c32 = phase_dryrun(torch)
    for k in counts:
        counts[k] += c32.get(k, 0)
    phase("33. the examples")
    phase_examples(torch)
    print(f"  ({time.perf_counter() - clock[0]:.1f} s)")
    print(f"  whole run {time.perf_counter() - t_start:.1f} s")

    meta = (
        ("fused_chain_down_fd", "chain", "chain_down", "parmgmc_tpu_torch/csrc/chain_march.cu",
         "parmgmc_tpu/kernels/mg_sweep.py:704"),
        ("fused_tail_down", "tail", "tail_down", "parmgmc_tpu_torch/csrc/tail_grid.cu",
         "parmgmc_tpu/kernels/mg_tail.py:175"),
        ("fused_rb_gibbs_sweep_fd", "sweep_fd", "rb_gibbs_fd", "parmgmc_tpu_torch/csrc/sweep_march.cu",
         "parmgmc_tpu/kernels/rb_gibbs.py:552"),
        ("fused_rb_gibbs_sweep", "sweep_streamed", "rb_gibbs", "parmgmc_tpu_torch/csrc/sweep_march.cu",
         "parmgmc_tpu/kernels/rb_gibbs.py:285"),
        ("fused_patch_sweep_sqfd", "patch", "patch_sweep", "parmgmc_tpu_torch/csrc/patch_sweep.cu",
         "parmgmc_tpu/kernels/patch_sweep.py:582"),
        ("fused_patch_sweep_sqfd_streamed", "patch_streamed", "patch_sweep_streamed",
         "parmgmc_tpu_torch/csrc/patch_sweep.cu", "parmgmc_tpu/kernels/patch_sweep.py:502"),
        ("fused_chain_down_2d_staged", "chain_2d_staged", "chain_2d_staged",
         "parmgmc_tpu_torch/csrc/chain_march.cu", "parmgmc_tpu/kernels/mg_sweep.py:1949"),
        ("fused_chain_down_2d", "chain_2d", "chain_2d", "parmgmc_tpu_torch/csrc/chain_march.cu",
         "parmgmc_tpu/kernels/mg_sweep.py:1235"),
        ("fused_zero_gibbs_restrict_fd", "zero_restrict", "zero_restrict",
         "parmgmc_tpu_torch/csrc/chain_march.cu", "parmgmc_tpu/kernels/mg_sweep.py:256"),
        ("fused_rb_gibbs_sweep_2d_staged", "sweep_2d_staged", "rb_gibbs_2d_staged",
         "parmgmc_tpu_torch/csrc/sweep_march.cu", "parmgmc_tpu/kernels/rb_gibbs.py:1310"),
        ("fused_rb_gibbs_sweep_2d", "sweep_2d", "rb_gibbs_2d", "parmgmc_tpu_torch/csrc/sweep_march.cu",
         "parmgmc_tpu/kernels/rb_gibbs.py:936"),
    )
    check(all(counts[ck] > 0 for _, _, ck, _, _ in meta), f"a kernel was not launched on its path: {counts}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=counts[ck], **rec[rk])
        for name, rk, ck, src, rep in meta
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    # with TEARDOWN_CUPTI=1 a process that ran a profiler session hangs
    # for minutes in its exit teardown, even after one session: end the
    # process here, once its output is out
    try:
        code = main()
    except BaseException:
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
