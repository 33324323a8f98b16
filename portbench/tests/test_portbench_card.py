"""One short run of each cell on the card (skips without one)."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

MAN = json.load(open(os.path.join(os.path.dirname(harness.PKG), "BENCHMARK.json")))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run([sys.executable, os.path.join(harness.PKG, "run.py"), "--workload", cell,
                        "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
