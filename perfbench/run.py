"""Entry point of the benchmark: one run of one cell (see core.py).

    python3 perfbench/run.py --workload cornell.render --seed 7 \
        --seconds 30 --trace 0
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], t0=T0))
