"""The control of a cell on the card, in one process: for each seed, one run
of the cell with the program's own path switched on that breaks one
guarantee of the configuration (workload.py says which, for each kind),
judged as a run is.  Prints one JSON line a seed with the numbers compared;
`correct` has to come out false on every seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds <s>
"""

import argparse
import json
import sys
import time

from run import forbidden_modules, load_benchmark, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    bench = load_benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = run_cell(bench, args.workload, seed, args.seconds, False, t_start=t0, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "judged": r["host"]["judged"],
                          "checks": r["checks"], "errors": r["errors"],
                          "seconds": r["seconds"]}), flush=True)
    found = forbidden_modules()
    if found:
        print(f"modules of the JAX package or JAX were loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
