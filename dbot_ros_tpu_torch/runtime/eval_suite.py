"""The port's accuracy suite: the JAX tracker's frames, the port's trackers.

Counterpart of ``benchmarks/eval_suite.py`` and of the 10k certification's
accuracy leg (``benchmarks/tpu_session26.py``, with the Gaussian tracker
of ``tpu_session30.py``). The frames come from ``tests/fixtures/
torch_eval/``, which ``tests/torch_eval_reference.py`` renders with the
JAX package's ``OracleSource``; its ``jax_reference.json`` holds, per
leg, the tracker configuration, the JAX tracker's metrics on the same
frames over tracker seeds, their mean and spread, and the bound the port
is held to. The port's random streams cannot match JAX's, so a leg is
judged on statistics over the same seeds:

* the port's mean position RMSE ≤ ``jax_mean + max(3·jax_sd, 1 mm)``;
* the mean rotation RMSE ≤ ``jax_mean + max(3·jax_sd, 0.02 rad)``
  (``two_obj``: object 1, a box, modulo its symmetry group);
* the mean worst position error over frames ≥ F//3 ≤ 2 cm wherever the
  JAX mean is under it.

Each run streams one fixture through ``runtime.sources.ReplaySource`` and
``runtime.node.run`` from frame 0's ground truth, with a tracker built
fresh from the leg's configuration and seed. A leg's ``launches`` are the
four CUDA kernels' launches over its runs (on the CPU the plain versions
run and count nothing).

Run: ``python -m dbot_ros_tpu_torch.runtime.eval_suite --fixtures
tests/fixtures/torch_eval [--set eval|production] [--device cuda|cpu]
[--out results.json] [--legs L,...] [--seeds A-B]``. The card is the
default device and the trackers run captured (``capture=None``), as
users run them; without CUDA it raises unless given ``--device cpu``.
The ``production`` set (the full-width main path) runs first, then
``eval``. It exits 1 if a leg is over its bound, a leg of ``FILED``
too. With ``--seeds`` other than 1-3 it judges no leg (the bound holds
the mean over seeds 1-3): it prints the means and spreads and exits 0.

``FILED`` names the legs that miss their bound for a cause that was
chased and written down (``ROADMAP.md`` §C), with the metrics they miss.
They are judged and reported over their bound like any other leg;
``unfiled`` gives the misses that are not filed, which fail
``chip_smoke.py``'s ``eval`` phase.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch.ops import kernels
from dbot_ros_tpu_torch.runtime import node
from dbot_ros_tpu_torch.runtime.sources import ReplaySource
from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker
from dbot_ros_tpu_torch.trackers.particle import (ParticleTracker,
                                                  resolve_device)
from dbot_ros_tpu_torch.utils import se3
from dbot_ros_tpu_torch.utils.camera import make_camera
from dbot_ros_tpu_torch.utils.mesh import box_mesh, l_shape_mesh

SETS = ("production", "eval")
# the port's seeds on every leg: the bound holds its mean over these (a
# JAX leg that took over a minute a run ran seed 1 only, its spread
# pooled from the estimator's other legs)
SEEDS = (1, 2, 3)
METRICS = ("pos_rmse_m", "rot_rmse_rad", "pos_max_m")
# legs over their bound on the card, and the metrics each misses, whose
# cause is filed in ROADMAP.md §C (Open 1): fed JAX's draws the port's
# step is JAX's on these frames, and over 13 JAX and 20 port seeds the
# two agree; the three JAX seeds of the bound happened to cluster
FILED = {"eval/nominal/pf-xla": ("pos_rmse_m", "rot_rmse_rad"),
         "production/occluder/pf-pallas": ("pos_max_m",)}
MESHES = {"l_shape": l_shape_mesh,
          "box(0.05, 0.07, 0.03)": lambda: box_mesh(0.05, 0.07, 0.03)}


def load_reference(fixtures) -> dict:
    with open(Path(fixtures) / "jax_reference.json") as fh:
        return json.load(fh)


def make_tracker(conf: dict, seed: int, camera, device):
    """A port tracker from a leg's configuration (``jax_reference.json``)
    with tracker seed ``seed``, captured on the card as users run it."""
    meshes = [MESHES[name]() for name in conf["meshes"]]
    obs = cfg.ObservationConfig(**conf["observation"])
    trans = cfg.TransitionConfig(**conf["transition"])
    if conf["estimator"] == "rgf":
        c = cfg.GaussianTrackerConfig(
            observation=obs, transition=trans, seed=seed,
            update_iterations=conf["update_iterations"],
            trust_sigma=conf["trust_sigma"])
        return GaussianTracker(c, meshes=meshes, camera=camera,
                               device=device)
    c = cfg.ParticleTrackerConfig(
        observation=obs, transition=trans, seed=seed,
        evaluation_count=conf["evaluation_count"],
        max_kl_divergence=conf["max_kl_divergence"],
        backend=conf["backend"],
        backend_options=dict(conf["backend_options"]))
    return ParticleTracker(c, meshes=meshes, camera=camera, device=device)


def fixture_camera(path, device):
    data = np.load(path)
    return make_camera(data["camera_matrix"], int(data["height"]),
                       int(data["width"]), device=device)


def run_metrics(run: node.TrackRun, scenario: str) -> dict:
    """``benchmarks/eval_suite.py``'s metrics: RMSE over every frame, the
    worst position error over frames ≥ F//3; for ``two_obj`` the rotation
    modulo the box's symmetry group for object 1, the naive one beside
    it."""
    sym = ([None, se3.box_symmetry_quats()] if scenario == "two_obj"
           else None)
    frames = len(run.poses)
    rec = {"pos_rmse_m": run.position_rmse(),
           "rot_rmse_rad": run.rotation_rmse(sym),
           "pos_max_m": float(run.position_errors()[frames // 3:].max())}
    if scenario == "two_obj":
        rec["rot_rmse_naive"] = run.rotation_rmse()
    return rec


def judge(mean: dict, bound: dict) -> list:
    """The metrics of ``mean`` over their bound (an empty list: within)."""
    return [k for k in METRICS
            if bound.get(k) is not None and not mean[k] <= bound[k]]


def unfiled(name: str, over: list) -> list:
    """The metrics of ``over`` (leg ``name``'s ``over_bound``) that
    ``FILED`` does not file for that leg."""
    return [k for k in over if k not in FILED.get(name, ())]


def run_leg(fixtures, name: str, ref: dict, device, seeds=SEEDS) -> dict:
    """One leg over ``seeds`` → the port's runs, mean and spread beside
    the JAX ones, the bound, whether the leg is within it, and which of
    the metrics over it are filed (``FILED``). The bound holds the mean
    over ``SEEDS``: over other seeds the leg is not judged (``passed``,
    ``over_bound`` and ``filed`` None)."""
    set_name, scenario, _ = name.split("/")
    path = Path(fixtures) / set_name / f"{scenario}.npz"
    camera = fixture_camera(path, device)
    seeds = list(seeds)
    before = {k: w.launches for k, w in kernels.WRAPPERS.items()}
    t0 = time.perf_counter()
    runs = []
    for seed in seeds:
        tracker = make_tracker(ref["config"], seed, camera, device)
        run = node.run(tracker, ReplaySource(str(path)))
        runs.append({"seed": seed, **run_metrics(run, scenario)})
        del tracker
    seconds = time.perf_counter() - t0
    mean = {k: float(np.mean([r[k] for r in runs])) for k in METRICS}
    sd = {k: (float(np.std([r[k] for r in runs], ddof=1))
              if len(runs) > 1 else None) for k in METRICS}
    over = judge(mean, ref["bound"]) if seeds == list(SEEDS) else None
    return {"set": set_name, "scenario": scenario,
            "estimator": ref["estimator"], "frames": ref["frames"],
            "particles": ref["particles"], "seeds": seeds, "runs": runs,
            "mean": mean, "sd": sd,
            "jax_mean": {k: ref["mean"][k] for k in METRICS},
            "jax_sd": {k: ref["sd"][k] for k in METRICS},
            "bound": ref["bound"], "over_bound": over,
            "passed": None if over is None else not over,
            "filed": (None if over is None else
                      [k for k in over if k in FILED.get(name, ())]),
            "launches": {k: w.launches - before[k]
                         for k, w in kernels.WRAPPERS.items()},
            "seconds": seconds}


def run_set(fixtures, set_name: str, device=None, legs=None, seeds=SEEDS,
            on_leg=None) -> dict:
    """Every leg of ``set_name`` (or only those named in ``legs``) →
    ``{"legs": {name: result}, "passed", "seconds"}`` (``passed`` None
    over other seeds than ``SEEDS``). ``device`` None is the card;
    ``on_leg(name, result)`` is called after each leg."""
    device = resolve_device(device)
    ref = load_reference(fixtures)
    t0 = time.perf_counter()
    out = {}
    for name, entry in ref["legs"].items():
        if entry["set"] != set_name or (legs is not None
                                        and name not in legs):
            continue
        out[name] = run_leg(fixtures, name, entry, device, seeds)
        if on_leg is not None:
            on_leg(name, out[name])
    return {"set": set_name, "device": str(device),
            "jax_commit": ref["jax_commit"], "legs": out,
            "passed": (None if list(seeds) != list(SEEDS) else
                       all(r["passed"] for r in out.values())),
            "seconds": time.perf_counter() - t0}


def _seed_range(text):
    a, _, b = text.partition("-")
    return list(range(int(a), int(b or a) + 1))


def _fmt(x):
    return "—" if x is None else f"{x:.5f}"


def _show(name, r):
    verdict = ("not judged" if r["passed"] is None else "ok"
               if r["passed"] else "OVER " + ",".join(r["over_bound"])
               + (" (filed: " + ",".join(r["filed"]) + ")"
                  if r["filed"] else ""))
    print(f"{name:32s} pos {_fmt(r['mean']['pos_rmse_m'])} (bound "
          f"{_fmt(r['bound']['pos_rmse_m'])})  rot "
          f"{_fmt(r['mean']['rot_rmse_rad'])} (bound "
          f"{_fmt(r['bound']['rot_rmse_rad'])})  {verdict}  "
          f"{r['seconds']:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dbot_ros_tpu_torch.runtime.eval_suite",
        description="Hold the port's trackers to the JAX tracker on the "
                    "same frames.")
    ap.add_argument("--fixtures", required=True,
                    help="directory holding jax_reference.json and the "
                         "frames (tests/fixtures/torch_eval)")
    ap.add_argument("--set", choices=SETS, action="append",
                    help="a set to run (default: production, then eval)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--legs", type=lambda s: s.split(","),
                    help="only these legs (set/scenario/estimator,...)")
    ap.add_argument("--seeds", type=_seed_range, default=SEEDS,
                    help="tracker seeds A-B in place of 1-3 (a leg's "
                         "spread over more seeds than the bound's): "
                         "prints means and spreads, judges no leg and "
                         "exits 0")
    args = ap.parse_args(argv)

    results = {}
    sets = args.set or [s for s in SETS if args.legs is None or any(
        leg.startswith(s + "/") for leg in args.legs)]
    for set_name in sets:
        results[set_name] = run_set(args.fixtures, set_name, args.device,
                                    legs=args.legs, seeds=args.seeds,
                                    on_leg=_show)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0 if all(r["passed"] is not False
                    for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
