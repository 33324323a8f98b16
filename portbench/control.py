"""Readings behind the limits of ``correct``: the program on many seeds
and the control on a few, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ... [--out <file.jsonl>]

Each seed runs the cell as ``run.py`` does (set-up, a window of
``--seconds`` at the cell's own load, the judged requests) and prints one
JSON line with the compared numbers.  A control seed judges, in the
program's place, the reference with every field it stores rounded to
bfloat16 (the precision below the configuration's float32; arithmetic in
float32) from the same judged starts.  The benchmark's
own runs never run the control."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

# (arithmetic, storage) of the control for the configuration's precision
LOWER = {"float32": ("float32", "bfloat16"), "float64": ("float32", None)}


def main(argv) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = os.path.dirname(harness.PKG)
    cell = harness.load_cell(root, args.workload)
    lower = tuple(t and getattr(torch, t) for t in LOWER[cell.config["dtype"]])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            out = harness.run(root, args.workload, seed, args.seconds, False, args.device, t0,
                              control=lower if kind == "control" else None)
            row = {"kind": kind, "seed": seed, "correct": out["correct"],
                   **{k: c["value"] for k, c in out["checks"].items()},
                   "requests": out["route"]["requests"]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    for kind in ("program", "control"):
        sel = [r for r in rows if r["kind"] == kind]
        for k in cell.workload["limits"]:
            if sel:
                v = [r[k] for r in sel]
                print(f"{kind} {k}: min {min(v)!r} max {max(v)!r} over {len(v)} seeds", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
