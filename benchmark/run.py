"""Entry point: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, run from the root of a checkout."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this file's folder, whose names would shadow others
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
