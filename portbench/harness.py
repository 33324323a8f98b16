"""The benchmark's run: one cell, one seed, one window.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs[*].file``), a traffic mix
(``portbench/traffic/<traffic>.json``) and its own file
(``portbench/workloads/<cell>.json``: the warm-up, the traced stretch, the
route and the limits of the comparison).  The configuration's ``drive``
names the module ``portbench/drives/<drive>.py`` whose ``Drive`` builds the
program and its reference (``request()``, ``record``, ``free()``,
``reference()``); each per-layer metric is ``portbench/metrics/<name>.py``.
Nothing here changes when a cell, a configuration, a mix or a metric is
added as files.

The traffic model: one client, a closed loop; a request asks the chain
for its next ``steps_per_request`` steps and brings their QOI to the host.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import random
import sys
import time
from dataclasses import dataclass

from portbench import stats, tracing

PKG = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "parmgmc_tpu")
JUDGED_SAMPLE = 2  # requests of the window judged beside the first and the last


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    workload: dict
    manifest: dict


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, entry=entry, manifest=manifest,
        config=_load_json(os.path.join(root, conf["file"])),
        traffic=_load_json(os.path.join(root, "portbench", "traffic", f"{entry['traffic']}.json")),
        workload=_load_json(os.path.join(root, "portbench", "workloads", f"{name}.json")),
    )


def drive_module(config: dict):
    return importlib.import_module(f"portbench.drives.{config['drive']}")


def metric_module(name: str):
    """``portbench/metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``parmgmc_tpu_torch`` is not ``parmgmc_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a per-layer metric reads: the cell, the window's QOI, the
    traced stretch and the steps it holds."""

    def __init__(self, cell, qoi, trace, steps_traced):
        self.cell, self.config, self.traffic = cell.name, cell.config, cell.traffic
        self.qoi, self.trace, self.steps_traced = qoi, trace, steps_traced


def _widest(a, b) -> float:
    """max |a - b|, infinite where either holds a NaN or an infinity."""
    d = float((a.double() - b.double()).abs().max())
    return d if math.isfinite(d) else math.inf


def judge(drive, records, program=None) -> dict:
    """The compared numbers over the judged requests, each a (start state,
    start key, end state, QOI on the host), against the drive's float64
    reference following each request from its start:

    * ``state_gap``: the widest gap of an end state from the reference's,
      over the reference state's widest value;
    * ``qoi_gap``: the widest gap of a step's QOI, over the widest
      reference QOI of the judged steps.

    ``program`` (a reference chain in a lower precision: the control)
    replaces the program's outputs."""
    import torch

    chain = drive.reference(torch.float64, records[0][0].device)
    state_gap, dq, qmax = 0.0, 0.0, 0.0
    for x0, key, x1, q in records:
        xr, qr = chain.follow(key, x0, drive.steps)
        if program is not None:
            x1, q = program.follow(key, x0, drive.steps)
        state_gap = max(state_gap, _widest(x1, xr) / float(xr.abs().max()))
        qr = qr.double().cpu().reshape(-1)
        dq = max(dq, _widest(torch.as_tensor(q).cpu().reshape(-1), qr))
        qmax = max(qmax, float(qr.abs().max()))
    return {"state_gap": state_gap, "qoi_gap": dq / qmax}


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(root: str, name: str, seed: int, seconds: float, trace: bool, device, t0: float,
        control=None) -> dict:
    """One run of cell ``name``; the result line as a dict.  ``t0`` is the
    process's start on the host clock (set-up counts from it).  ``control``
    (a (dtype, storage dtype or None) pair) judges, in the program's
    place, the reference computed so, from the same judged starts
    (``control.py``)."""
    import numpy as np
    import torch

    cell = load_cell(root, name)
    device = torch.device(device)
    drv_mod = drive_module(cell.config)
    drive = drv_mod.Drive(cell.config, cell.traffic, seed, device)
    wl = cell.workload

    # set-up: the cell's own shapes, the first request from the chain's start
    first = None
    for i in range(int(wl["warmup_requests"])):
        q = drive.request().cpu()
        if i == 0:
            first = (*drive.record, q)
    _sync(torch, device)
    from parmgmc_tpu_torch import kernels

    kernels.reset_launch_counts()
    setup_s = time.perf_counter() - t0

    # the window
    rng = random.Random(seed ^ 0x5EED)
    kept, last = [], None
    lat, qoi = [], []
    attempted = failed = 0
    n_trace = int(wl["trace_requests"]) if trace else 0
    prof = tracing.session(device.type) if trace else None
    if prof is not None:
        prof.__enter__()
    t_start = time.perf_counter()
    while True:
        a = time.perf_counter()
        attempted += 1
        try:
            if attempted <= n_trace:
                with torch.profiler.record_function(tracing.REQUEST):
                    q = drive.request().cpu()
            else:
                q = drive.request().cpu()
        except (RuntimeError, ValueError) as exc:  # the request failed: counted
            failed += 1
            print(f"request {attempted} failed: {exc!r}", file=sys.stderr)
            q = None
        b = time.perf_counter()
        if prof is not None and attempted == n_trace:
            prof.__exit__(None, None, None)
        lat.append(b - a)
        if q is not None:
            if not bool(torch.isfinite(q).all()):
                failed += 1
            qoi.append(q.reshape(drive.chains, -1))
            rec = (*drive.record, q)
            last = (attempted, rec)
            if len(kept) < JUDGED_SAMPLE:
                kept.append(last)
            else:
                j = rng.randrange(attempted)
                if j < JUDGED_SAMPLE:
                    kept[j] = last
        if b - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    if prof is not None and attempted < n_trace:
        prof.__exit__(None, None, None)
    _sync(torch, device)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    done = attempted - failed
    steps = done * drive.steps
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    qoi = torch.cat(qoi, dim=1).double().numpy() if qoi else np.zeros((drive.chains, 0))

    # the judged requests: the first (from the chain's start), a sample of
    # the window drawn from the seed, and the last
    records = [first] + [r for i, r in kept if last is None or i != last[0]]
    if last is not None:
        records.append(last[1])
    drive.free()
    del kept, last, first
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    program = None if control is None else drive.reference(control[0], device, store=control[1])
    numbers = judge(drive, records, program=program)
    del records
    judge_s = time.perf_counter() - t_judge
    limits = wl["limits"]
    correct = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}

    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.manifest["end_to_end"] + cell.manifest["per_layer"]}
    if not trace:
        tau = stats.mean_tau(qoi)
        smp = stats.sample_ms(window_s, steps, drive.chains)
        values = {
            "sample_ms": smp,
            "indep_sample_ms": stats.indep_sample_ms(smp, tau),
            "request_ms_p95": 1e3 * stats.percentile(lat, 95),
            "setup_s": setup_s,
        }
        for m in cell.manifest["end_to_end"]:  # a stuck chain's infinite tau is left out
            if name in m.get("workloads", [name]) and math.isfinite(values.get(m["name"], math.nan)):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed}
    if trace:
        tr = tracing.reduce(prof)
        ctx = Context(cell, qoi, tr, n_trace * drive.steps)
        for m in cell.manifest["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            v = metric_module(m["name"]).read(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
        dev["busy_s"] = tr.busy_s if tr else 0.0
        dev["window_s"] = tr.window_s if tr else 0.0
        out["breakdown"] = {"device_ops": tr.device_ops() if tr else [],
                            "idle_gaps": tr.idle_gaps() if tr else []}
    out["metrics"] = metrics
    out["device"] = dev
    out["route"] = {"launches": launches, "steps": steps, "requests": done, "window_s": window_s,
                    "judge_s": judge_s}
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return out


def main(argv, t0: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell of parmgmc_tpu_torch.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.path.dirname(PKG)
    cell = load_cell(root, args.workload)
    import parmgmc_tpu_torch  # noqa: F401  (the system under test: fail here without it)
    import torch

    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {args.workload} needs {need} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: the benchmark measures parmgmc_tpu_torch alone",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
