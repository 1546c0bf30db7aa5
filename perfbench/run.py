"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU.  The cell is an
entry of ``workloads`` in ``BENCHMARK.json``; its configuration, traffic mix,
metrics and limits are found by name under ``perfbench/``.  Without a card
the run exits non-zero and prints no result.
"""

import time

T_START = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
