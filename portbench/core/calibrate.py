"""Readings for the check's limits: a cell run on many seeds in one
process, with the program or, with ``--control``, with the control in
its place (``portbench/reference/control.py``). One JSON line a seed:
the compared numbers and whether they pass the current limits.

    python3 -m portbench.core.calibrate --workload pf10k.stream \
        --seeds 12 --seconds 3 [--control] [--first-seed N]
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from portbench.core import runner
    from portbench.reference import control

    factory = (control.factory(control.obj_text_from_settings)
               if args.control else None)
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        out = runner.run_cell(args.workload, seed, args.seconds, False,
                              tracker_factory=factory)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "correct": out["correct"],
                          "frames": out["info"]["frames"],
                          "checked": out["info"]["checked_frames"],
                          "notes": out["info"]["notes"],
                          "checks": {**out["info"]["uncompared"],
                                     **{k: v["value"] for k, v in
                                        out["checks"].items()}}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
