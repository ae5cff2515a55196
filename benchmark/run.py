"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with
`correct`, `attempted`, `failed`, `metrics` and `device` (and with
`--trace 1` a `breakdown`), and, as the last lines of standard error, each
number that decided `correct` beside its limit. Needs the CUDA cards the
cell asks for and exits non-zero, printing no result, without them.
"""

import pathlib
import sys
import time

STARTED = time.perf_counter()
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], STARTED))
