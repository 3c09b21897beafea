"""The control of `correct`, and the sound readings its limits are set
from: each seed's numbers compared, one JSON line a run.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 \
        --seconds <s> [--sound | --fault <name>] [--device cuda]

The control is the program with its configuration's `control_params`,
the nearest precision below the one the configuration states (float32
histograms lowered to the program's bfloat16 ones).  With --sound it
runs the program as configured instead, and with --fault <name> the
program with one of benchmark/faults.py's faults planted.  All seeds run
in one process.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import run, spec
from .faults import FAULTS, Patch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="{}")
    args = ap.parse_args(argv)
    bench = spec.load()
    cfg = spec.config(bench, spec.cell(bench, args.workload))
    control = not (args.sound or args.fault)
    if args.fault:
        FAULTS[args.fault](Patch)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = run.run_cell(args.workload, seed, args.seconds, False,
                         device=args.device, sizes=json.loads(args.sizes),
                         params=cfg["control_params"] if control else None,
                         t0=t0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "sound": args.sound, "fault": args.fault,
                          "control": control, "correct": r["correct"],
                          "metrics": r["metrics"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()}}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
