"""Each drive end to end on the CPU at a tiny size, through a
configuration file written in a temporary directory: a new configuration
and its cells are picked up with no edit of the harness."""

import json
import os
import subprocess
import sys
import time

import pytest

from portbench import harness
from cells import cells_of, small_names, tree

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tree(str(tmp_path_factory.mktemp("bench")), 32, 1)


@pytest.mark.parametrize("name", small_names())
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_host(root, name, trace):
    out = harness.run(root, name, 2**31 + 17, 0.5, bool(trace), "cpu", time.perf_counter())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    for k, c in out["checks"].items():
        assert c["value"] <= c["limit"], k
    man = json.load(open(os.path.join(root, "BENCHMARK.json")))
    want = {m["name"] for m in man["per_layer" if trace else "end_to_end"]}
    got = set(out["metrics"])
    if trace:  # the host has no device trace: those readers find nothing
        assert {"chain.host_ops_per_step", "sampler.tau"} <= got <= want
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want and all(v["value"] > 0 for v in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"


def test_one_chain_mesh_mix(root):
    """The mesh drive's one-chain route (``MaternMeshSampler.sample``),
    through a cell added as data: the ``chain1-r10`` mix, which no cell of
    the manifest uses yet."""
    import shutil

    man = json.load(open(os.path.join(root, "BENCHMARK.json")))
    base = next(w for w in man["workloads"] if w["name"].startswith("wrench-small-test"))
    name = "wrench-small-test.chain1-r10"
    if all(w["name"] != name for w in man["workloads"]):
        man["workloads"].append(dict(base, name=name, traffic="chain1-r10"))
        json.dump(man, open(os.path.join(root, "BENCHMARK.json"), "w"))
        wl = os.path.join(root, "portbench", "workloads")
        shutil.copy(os.path.join(wl, f"{base['name']}.json"), os.path.join(wl, f"{name}.json"))
    out = harness.run(root, name, 2**31 + 23, 0.5, False, "cpu", time.perf_counter())
    assert out["correct"] and out["route"]["steps"] % 10 == 0


@pytest.mark.parametrize("n", [16, 24])
def test_other_routes_of_the_hierarchy(tmp_path, n):
    """16^3 has no tail (level 1 is the coarsest), 24^3 a level the tail
    refuses: the reference follows the program's keying on each."""
    root = tree(str(tmp_path), n)
    name = next(c for c in cells_of(root, "grid") if c.endswith("prior-r192"))
    out = harness.run(root, name, 5, 0.2, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]


def test_same_seed_same_inputs(root):
    from portbench.drives import grid

    traffic = json.load(open(os.path.join(root, "portbench", "traffic", "balls5-r32.json")))
    a, b = grid.observations(traffic, 2**31 + 99), grid.observations(traffic, 2**31 + 99)
    assert all((a[k] == b[k]).all() if hasattr(a[k], "all") else a[k] == b[k] for k in a)
    assert not (grid.observations(traffic, 3)["coords"] == a["coords"]).all()


def test_command_refuses_without_a_card():
    """No card: a non-zero exit and no result line (never the CPU)."""
    r = subprocess.run([sys.executable, os.path.join(harness.PKG, "run.py"), "--workload",
                        "gmrf256-v10-prior", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and "{" not in r.stdout


def test_command_refuses_without_the_program(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone: a non-zero exit."""
    import shutil

    shutil.copy(os.path.join(os.path.dirname(harness.PKG), "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gmrf256-v10-prior",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert r.returncode != 0 and "{" not in r.stdout
    assert "parmgmc_tpu_torch" in r.stderr
