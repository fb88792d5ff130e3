"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU. The last
line of standard output is the result (JSON); the last lines of standard
error name each number compared with the reference beside its limit."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.core.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
