"""Run one cell of the tpu_ldpc_torch benchmark once, on the CUDA cards it
asks for (a cell of N > 1 cards: this process is rank 0 and starts the
other ranks, ``ldpcbench/ranks.py``).

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints each number the correctness
check compared, with its limit, as the last lines of standard error, and
one JSON object as the last line of standard output.  Exits with a
non-zero code, and prints no result, without a CUDA device, with fewer
cards than the cell asks for, or when the run loaded JAX or the JAX
package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from ldpcbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
