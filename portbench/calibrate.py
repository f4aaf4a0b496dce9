"""Readings for a cell's limits: the program over many seeds, the control over a few.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,... \\
        --control-seeds 101,102,103 [--fault-seeds 201,202,203] [--seconds 3]

Each seed is one run of the cell (``run.run_cell``) with a short window at
the cell's own load, comparing as many answers as a full run does; the
control's runs put the bfloat16 reference in the program's place
(``control.py``), and each fault's runs plant it in the program's step
(``faults.py``).  One process reads them all, so the card's context and
the program's libraries are set up once.  Prints one JSON line a run, then
a summary: each number's lower reading (the largest over the program's
runs) and upper reading (the smallest over the control's), and each
fault's smallest reading.  The benchmark's own runs never run the control
or a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

from portbench import checks, control, faults, run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.quiet_program_env()
    root = Path.cwd()
    run.fixed_caches(root)
    entry = spec.load(root, args.workload).traffic["entry"]
    sides = ["program", "control"] + [f for f in faults.FAULTS if faults.applies(f, entry)]
    readings: dict[str, list] = {side: [] for side in sides}
    plan = [("program", int(s)) for s in args.seeds.split(",") if s]
    plan += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    plan += [(f, int(s)) for f in sides[2:] for s in args.fault_seeds.split(",") if s]
    for side, seed in plan:
        fault = (faults.planted(side, entry) if side in faults.FAULTS
                 else contextlib.nullcontext())
        with fault:
            res = run.run_cell(root, args.workload, seed, args.seconds, False,
                               device=args.device,
                               control=control.make if side == "control" else None)
        row = {k: v["value"] for k, v in res["checks"].items()}
        readings[side].append(row)
        print(json.dumps({"side": side, "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "readings": row}), flush=True)
    summary = {"workload": args.workload}
    for name in checks.NAMES:
        lower = max((r[name] for r in readings["program"]), default=None)
        upper = min((r[name] for r in readings["control"]), default=None)
        summary[name] = {"lower": lower, "upper": upper,
                         "upper_over_lower": upper / lower if lower and upper else None}
        for f in sides[2:]:
            summary[name][f] = min((r[name] for r in readings[f]), default=None)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
