#!/usr/bin/env python3
"""Time the port's MGMC drives and large-plane kernels in several checkouts, alternating.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 time_main_path.py --trees OLD NEW --pairs 4 \\
        [--drive 256-v10 768-v10 768-v22 kernels] [--out FILE]

Each run is its own process, so every checkout imports its own
``parmgmc_tpu_torch`` (and builds its kernels under its own ``build/``);
one run times every drive asked for, in the order given.  The runs go OLD
NEW NEW OLD, OLD NEW NEW OLD, ... so that a drift of the host over the
call falls on both alike.  The drives (b = None, the aggregate hierarchy
with ``coarsening="aggregate"``, coarsest 128 DOF requested):

* ``256-v10``: ``chip_smoke.py`` phase 6's main path, gmrf_3d(256), MGMC
  V(1,0) through ``sample_chain_deferred``; 64 warm-up steps, then
  ``--repeats`` windows of 512 steps;
* ``768-v10``: the same chain on gmrf_3d(768) (phase 15); 8 warm-up
  steps, windows of 32;
* ``768-v22``: MGMC V(2,2) on gmrf_3d(768) through ``sample_chain`` with
  the mean as QOI (phase 18); 2 warm-up steps, windows of 8;
* ``kernels``: device ms per call (CUDA events over 10 calls after one
  warm-up) at 768^3 of #9 (b, noise), #8 (FD with b, and streamed D with
  b = None), #5 and #4 (the main path's call: b = None, z, sums, noise)
  and #3 summed over the six levels below 0 (b, noise), each with the
  coefficients of the 768^3 hierarchy.

A window is timed on the host clock and ended by
``torch.cuda.synchronize()``.  The last line is a JSON object with every
run's numbers and, per checkout and metric, the median and the range.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

DRIVES = ("256-v10", "768-v10", "768-v22", "kernels")
DEV = "cuda"
N_BIG = 768
# (grid, n_pre, n_post, warm-up steps, steps a window)
CHAINS = {"256-v10": (256, 1, 0, 64, 512), "768-v10": (768, 1, 0, 8, 32),
          "768-v22": (768, 2, 2, 2, 8)}


def time_chain(torch, drive, repeats):
    """ms/cycle of ``repeats`` windows of one MGMC drive."""
    from parmgmc_tpu_torch.chain import init_chain, sample_chain, sample_chain_deferred
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    n, n_pre, n_post, warm, steps = CHAINS[drive]
    op = gmrf_3d(n, kappa=1.0, device=DEV)
    smp = MGMCSampler.create(op, n_pre=n_pre, n_post=n_post, coarsest_size=128,
                             coarsening="aggregate")
    if n_post == 0:
        run = lambda st, k: sample_chain_deferred(smp, st, None, k)[0]
    else:
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


def time_kernels(torch):
    """Device ms per call of the large-plane kernels at 768^3."""
    from parmgmc_tpu_torch.kernels import _twin
    from parmgmc_tpu_torch.kernels import mg_sweep as ms
    from parmgmc_tpu_torch.kernels import rb_gibbs as rg
    from parmgmc_tpu_torch.models.problems import gmrf_3d
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    n = N_BIG
    smp = MGMCSampler.create(gmrf_3d(n, kappa=1.0, device=DEV), n_pre=1, n_post=0,
                             coarsest_size=128, coarsening="aggregate")
    gen = torch.Generator(device=DEV).manual_seed(2024)
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    s0 = smp.smoothers[0]
    coeffs, fd, omega = s0._coeff6(), s0.fd_params, s0.omega
    out = {}
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
    return out


def run_one(root, drives, repeats):
    """{metric: [numbers]} of every drive in the port in ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    res = {}
    for drive in drives:
        if drive == "kernels":
            res.update({k: [v] for k, v in time_kernels(torch).items()})
        else:
            res[f"{drive} ms/cycle"] = time_chain(torch, drive, repeats)
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
