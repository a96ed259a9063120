"""The readings that the limits of ``correct`` are set from, many seeds in one
process (each seed a whole run of the cell: set-up, a short window at the
cell's own load, the comparison):

    python3 -m h100_bench.readings --workload <name> --seeds <a,b,...> \\
        [--control engine|train|reference] [--seconds 3]

Without ``--control`` the program runs as its configuration states (the
lower readings); with it the configuration's control takes the program's
place (the upper readings): ``engine`` the program's own lower-precision
engine, ``train`` its lower-precision training path, ``reference`` the plain
reference in the control's precision. One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys

from h100_bench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m h100_bench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", choices=("engine", "train", "reference"))
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    for seed in args.seeds.split(","):
        numbers: dict = {}
        code, res = harness.run(["--workload", args.workload, "--seed", seed,
                                 "--seconds", str(args.seconds)],
                                control=args.control, log=lambda m: None, numbers_out=numbers)
        if code:
            return code
        print(json.dumps({"seed": int(seed), "control": args.control,
                          "correct": res["correct"], "failed": res["failed"],
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
