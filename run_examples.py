#!/usr/bin/env python3
"""Run every ported example at its documented defaults, one after another.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 run_examples.py --out results.jsonl [--only ex1 ex4 ...]

Each run calls the example's ``main(argv)`` in this process (so the
process reaches the card once) and appends one JSON line to ``--out``:
the label, the argv, the wall seconds of the call, the card as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
it, whether the example's own assert passed, and the dict it returned
(the numbers it prints; for the chain examples also ``chain_s``, the
seconds of the chain, and ``steps``, its steps with the burn-in).  A run
that fails its assert is recorded and the next run starts; the exit code
is the number of failed runs.  ``--only`` keeps the runs of the named
examples (a label's first word: ``ex1``, ``ex13_cholsampler``,
``benchmark_matern``, ...).
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

PRESETS = os.path.join("examples", "benchmark")

RUNS = [
    *((f"ex1 {s}", "ex1_samplers", ["--sampler", s]) for s in ("gibbs", "gibbs-symmetric", "cholesky", "mgmc")),
    *((f"ex4 {s}", "ex4_posterior", ["--sampler", s]) for s in ("gibbs", "mgmc", "woodbury")),
    ("ex9", "ex9_squared_prior", []),
    ("ex7", "ex7_convergence", []),
    ("ex2", "ex2_matern_iact", []),
    ("ex2 wrench", "ex2_matern_iact", ["--mesh", "wrench"]),
    ("ex13_cholsampler refine 4", "ex13_cholsampler", ["--refine", "4", "--samples", "64"]),
    ("ex13_cholsampler refine 3 mgmc", "ex13_cholsampler",
     ["--refine", "3", "--samples", "256", "--mgmc-samples", "2000"]),
    ("ex13_weak_scaling base 32", "ex13_weak_scaling", ["--devices", "1", "2", "4", "8"]),
    ("ex13_weak_scaling base 128", "ex13_weak_scaling", ["--devices", "1", "2", "4", "8", "--base", "128"]),
    ("ex13_weak_scaling chains", "ex13_weak_scaling", ["--devices", "1", "2", "4", "8", "--unstructured"]),
    ("ex13_weak_scaling dd", "ex13_weak_scaling",
     ["--devices", "1", "2", "4", "8", "--unstructured", "--domain-decompose"]),
    ("ex13_weak_scaling dd posterior", "ex13_weak_scaling",
     ["--devices", "1", "2", "4", "8", "--unstructured", "--domain-decompose", "--posterior"]),
    *((f"benchmark_matern {p}", "benchmark_matern", ["--preset", os.path.join(PRESETS, f"{p}.json")])
      for p in ("wrench", "lshape", "piece")),
    ("benchmark_matern wrench chains 256", "benchmark_matern",
     ["--preset", os.path.join(PRESETS, "wrench.json"), "--chains", "256"]),
    ("benchmark_matern wrench refine 1 anchor 64", "benchmark_matern",
     ["--preset", os.path.join(PRESETS, "wrench.json"), "--refine", "1", "--samples", "10000",
      "--anchor-ranks", "64"]),
    ("baseline_cpu_reference 128", "baseline_cpu_reference", ["128"]),
    ("make_meshes", "make_meshes", None),  # into a temporary directory, compared with data/*.msh
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="JSON lines file to append the runs to")
    ap.add_argument("--only", nargs="+", default=None, help="the examples to run (a label's first word)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    runs = [r for r in RUNS if args.only is None or r[0].split()[0] in args.only]
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        for label, name, argv in runs:
            if argv is None:
                argv = ["--outdir", tmp]
            print(f"== {label}: python -m parmgmc_tpu_torch.examples.{name} {' '.join(argv)}", flush=True)
            mod = importlib.import_module(f"parmgmc_tpu_torch.examples.{name}")
            t0 = time.perf_counter()
            try:
                out = mod.main(argv)
                ok, err = True, None
            except Exception as e:  # recorded; the next run starts
                out, ok, err = None, False, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                print(err, flush=True)
            wall = time.perf_counter() - t0
            if ok and name == "make_meshes":
                same = {k: open(v["path"], "rb").read() == open(os.path.join("data", f"{k}.msh"), "rb").read()
                        for k, v in out.items()}
                out = dict(out, same_bytes_as_data=same)
                ok = all(same.values())
            failed += not ok
            rec = dict(label=label, module=name, argv=argv, wall_s=wall, card=smi, ok=ok, out=out, error=err)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
            print(f"   {label}: {'passed' if ok else 'FAILED'} in {wall:.1f} s", flush=True)
    print(f"{len(runs) - failed} passed, {failed} failed; {smi}")
    return failed


if __name__ == "__main__":
    sys.exit(main())
