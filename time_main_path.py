#!/usr/bin/env python3
"""Time the port's V(1,0) 256^3 main path in several checkouts, alternating.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 time_main_path.py --trees OLD NEW --pairs 10 [--out FILE]

Each run is its own process, so every checkout imports its own
``parmgmc_tpu_torch`` (and builds its kernels under its own ``build/``).
The runs go OLD NEW NEW OLD, OLD NEW NEW OLD, ... so that a drift of the
host over the call falls on both alike.  A run is the main path of
``chip_smoke.py`` phase 6: gmrf_3d(256), MGMC V(1,0), aggregate hierarchy,
coarsest 512 DOF, b = None, ``sample_chain_deferred``; 64 warm-up steps,
then ``--repeats`` windows of 512 steps, each timed on the host clock and
ended by ``torch.cuda.synchronize()``.  The last line is a JSON object
with every window's ms/cycle and, per checkout, the median and the range.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

N_MAIN = 256
N_WARM = 64
N_TIME = 512


def run_one(root, repeats):
    """ms/cycle of `repeats` windows of the main path of the port in `root`."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from parmgmc_tpu_torch.chain import init_chain, sample_chain_deferred
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    op = gmrf_3d(N_MAIN, kappa=1.0, device="cuda")
    smp = MGMCSampler.create(op, n_pre=1, n_post=0, coarsest_size=128)
    st, _ = sample_chain_deferred(smp, init_chain(smp, 0), None, N_WARM)
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        st, _ = sample_chain_deferred(smp, st, None, N_TIME)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / N_TIME * 1e3)
    if not bool(torch.isfinite(st.x).all()):
        raise RuntimeError(f"{root}: the chain state is not finite")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="checkout roots to compare")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3, help="512-step windows per run")
    ap.add_argument("--out", help="also write the result JSON here")
    ap.add_argument("--run", help=argparse.SUPPRESS)  # one run, in a child process
    args = ap.parse_args()
    if args.run:
        print(json.dumps(run_one(args.run, args.repeats)))
        return 0
    trees = args.trees
    order = []
    for p in range(args.pairs):
        order += trees if p % 2 == 0 else trees[::-1]
    runs = {t: [] for t in trees}
    for i, t in enumerate(order):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", t, "--repeats", str(args.repeats)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        runs[t].append(ms)
        print(f"run {i + 1}/{len(order)} {t}: " + " ".join(f"{m:.4f}" for m in ms) + " ms/cycle")
    summary = {}
    for t, rs in runs.items():
        firsts = [r[0] for r in rs]
        every = [m for r in rs for m in r]
        summary[t] = dict(median_first=statistics.median(firsts), median=statistics.median(every),
                          min=min(every), max=max(every), n=len(every))
        print(f"{t}: median {summary[t]['median']:.4f} ms/cycle over {len(every)} windows "
              f"(first windows {summary[t]['median_first']:.4f}), range "
              f"{summary[t]['min']:.4f}..{summary[t]['max']:.4f}")
    result = {"order": order, "runs": runs, "summary": summary}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
