"""Run one benchmark cell of parmgmc_tpu_torch and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See portbench/README.md."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("OMP_NUM_THREADS", "1")  # one process, few threads: steadier host timings
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
