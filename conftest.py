"""Test-session hook shared by the repo's test trees.

``portbench/tests/cells.py`` builds the benchmark's CPU test trees from a
table of drives (``cells.SMALL``); a drive added by a cell of its own
registers here, before anything under ``portbench/tests`` is collected
(``test_portbench_drive.py`` reads the table while it is imported)."""

import os
import sys

BENCH_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench", "tests")


def pytest_collectstart(collector):
    cells = sys.modules.get("cells")
    if cells is not None and str(collector.path).startswith(BENCH_TESTS):
        # drive -> (the small configuration's name, the key that sizes it)
        cells.SMALL.setdefault("grid_slabs", ("gmrf3d-slabs-small-test", "n"))
        cells.SMALL.setdefault("grid_cycle_slabs", ("gmrf3d-cycle-slabs-small-test", "n"))
