"""A benchmark tree in a temporary directory: the repo's BENCHMARK.json,
mixes and cell files, with configurations of its own written there."""

import json
import os
import shutil

from portbench import harness

ROOT = os.path.dirname(harness.PKG)
SMALL = {"grid": ("gmrf3d-small-test", "n"), "mesh": ("wrench-small-test", "refinements")}


def tree(tmp, n: int = 32, refinements: int = 1) -> str:
    """``tmp`` holding BENCHMARK.json with a new configuration for each of
    the repo's (the grid at n^3, the mesh refined ``refinements`` times)
    and a cell ``<config>.<traffic>`` for each of the repo's cells; returns
    the root."""
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    os.makedirs(os.path.join(tmp, "portbench", "configs"))
    for d in ("traffic", "workloads"):
        shutil.copytree(os.path.join(harness.PKG, d), os.path.join(tmp, "portbench", d))
    names = {}
    for c in man["configs"]:
        body = json.load(open(os.path.join(ROOT, c["file"])))
        new, key = SMALL[body["drive"]]
        body.update({"name": new, key: n if key == "n" else refinements})
        path = f"portbench/configs/{new}.json"
        json.dump(body, open(os.path.join(tmp, path), "w"))
        c.update(name=new, file=path)
        names[body["name"]] = new
    old = {c["name"]: c for c in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["configs"]}
    cells = []
    for w in man["workloads"]:
        drive = json.load(open(os.path.join(ROOT, old[w["config"]]["file"])))["drive"]
        name = f"{SMALL[drive][0]}.{w['traffic']}"
        shutil.copy(os.path.join(harness.PKG, "workloads", f"{w['name']}.json"),
                    os.path.join(tmp, "portbench", "workloads", f"{name}.json"))
        cells.append(dict(w, name=name, config=SMALL[drive][0]))
    man["workloads"] = cells
    for m in man["per_layer"] + man["end_to_end"]:
        m.pop("workloads", None)
    json.dump(man, open(os.path.join(tmp, "BENCHMARK.json"), "w"))
    return tmp


def small_names(drive=None) -> list:
    """The cell names :func:`tree` makes, read off the repo's manifest."""
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    drives = {c["name"]: json.load(open(os.path.join(ROOT, c["file"])))["drive"] for c in man["configs"]}
    return [f"{SMALL[drives[w['config']]][0]}.{w['traffic']}" for w in man["workloads"]
            if drive in (None, drives[w["config"]])]


def cells_of(root, drive=None) -> list:
    man = json.load(open(os.path.join(root, "BENCHMARK.json")))
    return [w["name"] for w in man["workloads"] if drive is None or w["name"].startswith(SMALL[drive][0])]
