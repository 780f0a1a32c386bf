"""The benchmark of zs3_tpu_torch: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  See benchmark/harness.py."""

import sys

from benchmark.harness import main

if __name__ == "__main__":
    sys.exit(main())
