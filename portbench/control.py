"""Read the numbers a cell's limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
                                 [--fault <name>]

For each seed one run of the cell (a window of ``--seconds``, which need
only finish as many calls or epochs as the check compares), then the
program's numbers (the lower reading's) and the control's: the plain
reference in TF32, the next precision below float32 with TF32 off, put in
the program's place.  ``--fault`` plants one of ``portbench/faults.py``'s
faults under the timed path first.  One JSON line a seed on standard
output.  The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import common, faults, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    p.add_argument("--no-control", action="store_true")
    args = p.parse_args(argv)
    common.set_cache_dirs()
    bench = common.manifest()
    cell, traffic, config = common.cell_files(args.workload, bench)
    with faults.planted(args.fault):
        for seed in args.seeds:
            r = run.run_cell(args.workload, cell, traffic, config, seed, args.seconds, False,
                             "cuda", bench, control=not args.no_control)
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                              "program": r["numbers"], "control": r["control"],
                              "correct": r["correct"], "window": r["window"],
                              "card": [r["device"]["kind"], r["power_limit"]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
