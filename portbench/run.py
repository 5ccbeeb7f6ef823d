"""Run one benchmark cell once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs the CUDA device(s) the cell asks for; without them it prints no
result and exits non-zero. See portbench/harness.py.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(sys.argv[1:]))
