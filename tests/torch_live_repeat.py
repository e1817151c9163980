#!/usr/bin/env python3
"""Repeat the live phase of ``chip_smoke.py`` and print each run's live
line.

On one NVIDIA GPU, from the repository root:

    python tests/torch_live_repeat.py --runs 10 [--root DIR]

``--root`` is a checkout whose ``chip_smoke.py`` and package are used
(default: this repository), for example a parent commit unpacked with
``git archive`` into ``build/parent/``: two trees then run in one call,
one after the other. The kernels are built once, then
``chip_smoke.phase_live`` runs ``--runs`` times in this process. Its
checks are recorded instead of raised, so that a failing tree still
prints its live line. Each run prints one JSON line: the tree, the
checks that failed, the largest position error over the frames from the
search's on (computed here from the run's poses: an older tree's live
line lacks it) and the live line itself.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def one_run(smoke, dev, card):
    """One live phase → (the checks that failed, the live line, the
    largest error from the search's frame on)."""
    failed, lines, runs = [], [], []
    check, emit, run = smoke.check, smoke.emit, smoke.node.run

    def keep_run(*args, **kwargs):
        runs.append(run(*args, **kwargs))
        return runs[-1]

    smoke.check = lambda cond, msg: cond or failed.append(str(msg)[:2000])
    smoke.emit, smoke.node.run = lines.append, keep_run
    try:
        smoke.phase_live(dev, card)
    except Exception as e:  # noqa: BLE001 - reported as the run's failure
        failed.append(f"{type(e).__name__}: {e}"[:2000])
    finally:
        smoke.check, smoke.emit, smoke.node.run = check, emit, run
    since = None
    if runs and runs[-1].reinit_frames:
        tr = runs[-1]
        err = np.linalg.norm(tr.poses[:, 0, :3] - tr.ground_truth[:, 0, :3],
                             axis=1)
        since = float(max(e for m, e in zip(tr.metrics.records, err)
                          if m.frame >= tr.reinit_frames[0]))
    live = next((x for x in lines if x.get("phase") == "live"), None)
    return failed, live, since


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose chip_smoke.py and package run")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as smoke
    import torch

    card = smoke.phase_device()
    smoke.phase_build()
    for i in range(args.runs):
        t0 = time.perf_counter()
        failed, live, since = one_run(smoke, torch.device("cuda"), card)
        print(json.dumps({"tree": root.name, "run": i, "failed": failed,
                          "since_search_max_error_m": since,
                          "seconds": time.perf_counter() - t0,
                          "live": live}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
