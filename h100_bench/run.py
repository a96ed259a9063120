"""Run one benchmark cell:

    python3 -m h100_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The last line of standard output is the result's JSON; the numbers
compared against the plain reference are the last lines of standard error.
"""

import sys

from h100_bench.harness import main

if __name__ == "__main__":
    sys.exit(main())
