"""Run one cell of the benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA cards the cell
asks for. The last line of standard output is the result's JSON object;
the compared numbers and their limits are the last lines of standard
error. Without enough cards it prints no result and exits with 4.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout, not this folder, is the import root

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T0))
