"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.PKG)
MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|experts_per_tok|_dim$|_rank$)")


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["paths"]) <= 16 and len(MAN["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p and not p.startswith("/")
        assert not p.endswith("_torch")
    for word in MAN["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(key):
    names = [e["name"] for e in MAN[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metrics_units_and_fields():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert os.path.exists(os.path.join(harness.PKG, "metrics", f"{m['name']}.py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in MAN["configs"]}
    cells = MAN["workloads"]
    assert {w["config"] for w in cells} == set(configs)  # every configuration used
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
        cell = harness.load_cell(ROOT, w["name"])  # the config, mix and cell files exist
        assert set(cell.workload["limits"]) and cell.workload["trace_requests"] >= 1
        assert harness.drive_module(cell.config).Drive
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert body["reduced"] == c["reduced"] and "assumed" in body and body["dtype"]
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTHS.search(k)


def test_every_cell_reports_what_it_must():
    for w in MAN["workloads"]:
        e2e = [m for m in MAN["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        layers = [m for m in MAN["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layers
        for m in layers:  # the metric it moves is reported in that cell
            assert m["moves"] in {e["name"] for e in e2e}
    for m in MAN["per_layer"] + MAN["end_to_end"]:
        for c in m.get("workloads", []):
            assert c in {w["name"] for w in MAN["workloads"]}


def test_layer_names_agree():
    layers = {}
    for m in MAN["per_layer"]:
        prefix = m["name"].split(".")[0]
        layers.setdefault(prefix, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
