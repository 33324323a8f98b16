"""Configurable Matérn benchmark (the port of the reference's benchmark/ harness).

The reference's examples/benchmark/main.cc + benchmarkrc / wrench.opts:
burn-in and sampling phases over a Gmsh-mesh Matérn problem (optionally
with low-rank observations), Welford mean/var, and the three headline
prints: time per sample, IACT of a QOI, and time per independent sample
(max(tau, 1) * T / n).

Presets mirroring the reference's .opts files (mesh, observations, QOI
region) are the JSON files of the checkout's ``examples/benchmark/``:

    python -m parmgmc_tpu_torch.examples.benchmark_matern --preset examples/benchmark/wrench.json \\
        --refine 1 --samples 10000 --anchor-ranks 64 [--device cuda]

``--chains N`` runs N independent chains chain-major (one (n, N) state,
one keyed step advancing every chain; ``MaternMeshSampler.sample_chains``)
in one call of ``--samples`` steps after ``--burnin``.  ``--anchor-ranks
N`` also times the reference's multicolour CSR SOR hot loop on THIS
problem's assembled matrix (one host core, native code:
``native/ref_sor_bench.cpp``'s ``pmg_ref_sor_bench_csr``) and reports this
run's throughput against an N-rank perfect-scaling model of the
reference, the methodology of ``baseline_cpu_reference``.
"""

import argparse
import json
import math
import time

import numpy as np
import torch

from parmgmc_tpu_torch.diagnostics.iact import iact
from parmgmc_tpu_torch.examples import add_device_flag, example_device, synchronize
from parmgmc_tpu_torch.models.matern import MaternMeshSampler, region_qoi

__all__ = ["main", "region_qoi"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default=None,
                    help="JSON preset (examples/benchmark/*.json), the "
                    "analogue of the reference's .opts files")
    ap.add_argument("--mesh", default=None,
                    help="mesh asset name or path (models.mesh.mesh_path: "
                    "the checkout's data/)")
    ap.add_argument("--refine", type=int, default=0)
    ap.add_argument("--kappa", type=float, default=5.0)
    ap.add_argument("--burnin", type=int, default=1000)
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--posterior", action="store_true")
    ap.add_argument("--sigma2", type=float, default=2.5e-3)
    ap.add_argument("--dtype", default="f64", choices=["f32", "f64"])
    ap.add_argument("--order", type=int, default=1, choices=[1, 2],
                    help="FE order (2 = CG2, the reference ex13 space)")
    ap.add_argument("--hierarchy", default="algebraic",
                    choices=["algebraic", "geometric"],
                    help="geometric needs --refine >= 1 and order 1")
    ap.add_argument("--anchor-ranks", type=int, default=0,
                    help="if > 0, measure the reference CSR SOR hot loop "
                    "on this matrix and report vs an N-rank model; pick "
                    "ranks ~ DOFs/4k (the reference's ex13 weak-scaling "
                    "grain), not 64 for tiny meshes")
    ap.add_argument("--chains", type=int, default=1,
                    help="independent chains, chain-major (the production "
                    "configuration for launch-bound mesh problems: total "
                    "throughput = chains x per-chain rate)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    preset = {}
    if not args.preset and args.mesh is None:
        args.mesh = "wrench"
    if args.preset:
        with open(args.preset) as f:
            preset = json.load(f)
        if args.mesh is None:  # an explicit --mesh wins over the preset
            args.mesh = preset.get("mesh")
        args.kappa = float(preset.get("kappa", args.kappa))
        args.sigma2 = float(preset.get("sigma2", args.sigma2))
        if preset.get("posterior"):
            args.posterior = True

    obs = None
    if args.posterior:
        obs = dict(
            sigma2=args.sigma2,
            coords=preset.get(
                "obs_coords", [[0, 125, 0], [30, 35, 0], [-15, 100, 0]]
            ),
            radii=preset.get("obs_radii", [10.0, 10.0, 10.0]),
            values=preset.get("obs_values", [1.0, -1.0, 2.0]),
        )
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    ms = MaternMeshSampler(
        mesh_file=args.mesh,
        kappa=args.kappa,
        refinements=args.refine,
        dtype=dtype,
        observations=obs,
        coarsest_size=128,
        order=args.order,
        hierarchy=args.hierarchy,
        device=dev,
    )
    print(f"DOFs: {ms.n}   levels: {ms.sampler.n_levels}")
    level_sizes = [math.prod(o.grid_shape) for o in ms.sampler.ops]
    out = dict(dofs=ms.n, levels=ms.sampler.n_levels, level_sizes=level_sizes, chains=args.chains)
    w = region_qoi(ms.points, preset) if preset else None
    if w is not None and w.shape[0] != ms.n:  # e.g. the CG2 dof space
        w = None
    if w is not None:
        wd = torch.as_tensor(w, device=dev).to(dtype)
        ms.set_qoi(lambda x, wd=wd: x @ wd)
        print(f"QOI: {preset['qoi_type']} region mean "
              f"({int((np.asarray(w) > 0).sum())} nodes)")
        out["qoi_nodes"] = int((np.asarray(w) > 0).sum())
    else:
        ms.set_qoi(lambda x: torch.mean(x))

    if args.chains > 1:
        # many chains: the graph samplers run CHAIN-MAJOR (one (n, C)
        # state, every gather amortized over the chain axis); the samples
        # run in one call (no dispatch chunking: a chunk past --samples
        # would add steps to the timed wall)
        t00 = time.perf_counter()

        def note(msg):
            print(f"[{time.perf_counter() - t00:7.1f}s] {msg}", flush=True)

        note("setup done; running the burn-in")
        ms.sample_chains(args.burnin, args.chains)
        synchronize(dev)
        note("burn-in done")
        t0 = time.perf_counter()
        q = ms.sample_chains(args.samples, args.chains).cpu().numpy()
        wall = time.perf_counter() - t0
        note(f"{args.samples} steps done")
        taus, valids = iact(q)
        tau = float(np.maximum(taus, 1.0).mean())
        valid = bool(np.all(valids))
        nrec = q.shape[1]
        tps = wall / (nrec * args.chains) * 1000
        print(f"chains: {args.chains} (chain-major)")
        print(f"Time per sample [ms, aggregate]: {tps:.4f}")
        print(f"IACT (mean over chains): {tau:.3f}"
              f"{'' if valid else ' (window short)'}")
        # tau transparency: the chain-mean tau over three half-windows of
        # the trace; the single-window IACT estimate swings with the
        # section at short windows, so a headline number is only
        # trustworthy when the sections agree
        m = q.shape[1]
        secs = []
        for lo, hi in ((0, m // 2), (m // 4, 3 * m // 4), (m // 2, m)):
            t_s, _ = iact(q[:, lo:hi])
            secs.append(round(float(np.maximum(t_s, 1.0).mean()), 3))
        print(f"tau_sections (half-windows, chain mean): {secs}")
        print(f"Time per independent sample [ms]: {tau * tps:.4f}")
    else:
        ms.sample(args.burnin)
        synchronize(dev)

        t0 = time.perf_counter()
        q = ms.sample(args.samples).cpu().numpy()
        wall = time.perf_counter() - t0

        tau, valid = iact(q)
        tau = max(float(tau), 1.0)
        tps = wall / args.samples * 1000
        print(f"Time per sample [ms]: {tps:.4f}")
        print(f"IACT: {tau:.3f}{'' if valid else ' (window short)'}")
        m = q.shape[0]
        secs = []
        for lo, hi in ((0, m // 2), (m // 4, 3 * m // 4), (m // 2, m)):
            t_s, _ = iact(q[lo:hi])
            secs.append(round(max(float(t_s), 1.0), 3))
        print(f"tau_sections (half-windows): {secs}")
        print(f"Time per independent sample [ms]: {tau * tps:.4f}")
    out.update(ms_per_sample=tps, tau=tau, valid=bool(valid), tau_sections=secs, ms_per_indep_sample=tau * tps,
               wall_s=wall)

    if args.anchor_ranks > 0:
        from parmgmc_tpu_torch.native import ref_sor_bench_csr

        n, s_sweep, s_fill = ref_sor_bench_csr(ms.op.to_csr(), nsweeps=4)
        # the perfect-scaling model, generous to the reference (the
        # methodology of baseline_cpu_reference): a V(1,0)-equivalent
        # cycle = (1 sweep + 1 residual + 0.25 transfer) a level, summed
        # over the MEASURED level-size ratios of this hierarchy; the noise
        # fill, the coarse exact solve and the halos granted free; matched
        # IACT (the tau term cancels in the ratio)
        recursion = sum(s / level_sizes[0] for s in level_sizes[:-1])
        sec_cycle_1core = 2.25 * recursion * s_sweep
        anchor_sps = args.anchor_ranks / sec_cycle_1core
        ours_sps = 1000.0 / tps
        print(
            f"anchor: CSR SOR {n} DOFs, {s_sweep * 1e3:.2f} ms/sweep/core "
            f"({n / s_sweep / 1e6:.1f} MDOF/s), fill {s_fill * 1e3:.2f} ms"
        )
        print(
            f"anchor model ({args.anchor_ranks} ranks, perfect scaling): "
            f"{anchor_sps:.1f} samples/s; this run: {ours_sps:.1f} "
            f"samples/s -> vs_anchor {ours_sps / anchor_sps:.2f}x "
            f"(matched IACT)"
        )
        out.update(anchor_n=n, anchor_sec_sweep=s_sweep, anchor_sec_fill=s_fill, recursion=recursion,
                   anchor_samples_per_s=anchor_sps, samples_per_s=ours_sps, vs_anchor=ours_sps / anchor_sps)
    return out


if __name__ == "__main__":
    main()
