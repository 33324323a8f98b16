"""The drives the test trees of ``portbench/tests/cells.py`` build small
configurations for, beside the grid and the mesh: ``grid_cycle`` (the
linear-Galerkin hierarchy, ``drives/grid_cycle.py``), whose small
configurations take the grid's extent ``n``."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))

import cells  # noqa: E402

cells.SMALL.setdefault("grid_cycle", ("gmrf3d-cycle-small-test", "n"))
