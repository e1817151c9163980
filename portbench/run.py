"""Run one cell of the benchmark of ``dbot_ros_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads, warms up, measures for ``--seconds``, checks the window's poses
against the plain reference, and prints the result as the last line of
standard output (one JSON object); each compared number and its limit go
to standard error as its last lines, and into the result under
``checks``. Exits non-zero, printing no result, without a CUDA device,
when the program cannot be imported, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _env():
    """Caches of the program live in fixed directories inside the
    checkout; JAX stays out of the process."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "portbench" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "portbench" / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()

    import torch
    from portbench.core import spec
    try:
        cell = spec.workload(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import dbot_ros_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 4

    from portbench.core import runner
    try:
        out = runner.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_process=T_PROCESS)
    except runner.ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 5
    found = runner.forbidden_modules()
    if found:
        print("portbench: loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 5
    for name, v in out["info"]["uncompared"].items():
        print(f"reading {name} {v!r} (not compared)", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
