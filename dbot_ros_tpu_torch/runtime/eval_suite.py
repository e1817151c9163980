"""The port's accuracy suite: the JAX tracker's frames, the port's trackers.

Counterpart of ``benchmarks/eval_suite.py`` and of the 10k certification's
accuracy leg (``benchmarks/tpu_session26.py``, with the Gaussian tracker
of ``tpu_session30.py``). The frames come from ``tests/fixtures/
torch_eval/``, which ``tests/torch_eval_reference.py`` renders with the
JAX package's ``OracleSource``; its ``jax_reference.json`` holds, per
leg, the tracker configuration and the JAX tracker's metrics on the same
frames for each tracker seed, and ``bound_rule``, the rule the port is
held to (this module keeps no copy of its numbers). The port's random
streams cannot match JAX's, so a leg is judged on samples over the same
seeds, per metric (position RMSE, rotation RMSE, ``two_obj``'s object 1
modulo the box's symmetry group, and the worst position error over
frames ≥ F//3):

* particle-filter legs (``two_sample``), seeds 1-10 a side: a one-sided
  Welch test of non-inferiority. The leg fails a metric when
  ``mean_p − mean_j > δ + T·sqrt(s_p²/n_p + s_j²/n_j)``, T the 0.999
  quantile of Student's t at 9 degrees of freedom; each leg also reports
  how many seeds of each side go over 2 cm in the worst error;
* Gaussian legs (``deterministic``: JAX's spread is 0), seeds 1-3: the
  port's mean ≤ JAX's + a floor, and the worst error ≤ 2 cm where JAX's
  mean is under it.

Per metric a judged leg gives ``diff`` (mean_p − mean_j), ``threshold``
(what ``diff`` may reach) and ``slack`` (threshold − diff).

Each run streams one fixture through ``runtime.sources.ReplaySource`` and
``runtime.node.run`` from frame 0's ground truth, with a tracker built
fresh from the leg's configuration and seed. A leg's ``launches`` are the
four CUDA kernels' launches over its runs (on the CPU the plain versions
run and count nothing).

Run: ``python -m dbot_ros_tpu_torch.runtime.eval_suite --fixtures
tests/fixtures/torch_eval [--set eval|production] [--device cuda|cpu]
[--out results.json] [--legs L,...] [--seeds A-B]``. The card is the
default device and the trackers run captured, as users run them; without
CUDA it raises unless given ``--device cpu``. The ``production`` set
(the full-width main path) runs first, then ``eval``. It exits 1 if a
leg fails its rule. A leg run over other seeds than its rule's is not
judged: it prints the means and spreads, and that leg fails nothing.
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
METRICS = ("pos_rmse_m", "rot_rmse_rad", "pos_max_m")
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


def _sample(runs, k):
    return np.array([r[k] for r in runs], np.float64)


def judge(rule_name: str, rule: dict, runs: list, jax_runs: list) -> dict:
    """Per metric, the port's ``runs`` against JAX's ``jax_runs`` under
    ``bound_rule[rule_name]``: ``{"diff", "threshold", "slack",
    "failed"}`` (``threshold`` None where the rule sets none).
    ``two_sample`` needs the rule's number of seeds on each side and a
    spread on each: it raises rather than judge without them."""
    checks = {}
    for k in METRICS:
        p, j = _sample(runs, k), _sample(jax_runs, k)
        diff = float(p.mean() - j.mean())
        if rule_name == "two_sample":
            n = len(rule["seeds"])
            if len(p) != n or len(j) != n:
                raise ValueError(f"{k}: the rule needs {n} seeds a side, "
                                 f"got {len(p)} and {len(j)}")
            sp, sj = p.std(ddof=1), j.std(ddof=1)
            if not (sp > 0 and sj > 0):
                raise ValueError(f"{k}: a sample without spread (sd "
                                 f"{sp:g} and {sj:g}) cannot be judged")
            threshold = float(rule["margin"][k] + rule["t"] * np.sqrt(
                sp ** 2 / len(p) + sj ** 2 / len(j)))
            failed = diff > threshold
        elif k in rule["floor"] or j.mean() < rule["pos_max_limit_m"]:
            bound = (j.mean() + rule["floor"][k] if k in rule["floor"]
                     else rule["pos_max_limit_m"])
            threshold, failed = float(bound - j.mean()), not p.mean() <= bound
        else:
            threshold, failed = None, False
        checks[k] = {"diff": diff, "threshold": threshold,
                     "slack": None if threshold is None else threshold - diff,
                     "failed": bool(failed)}
    return checks


def run_leg(fixtures, name: str, ref: dict, rules: dict, device,
            seeds=None) -> dict:
    """One leg over ``seeds`` (None: its rule's) → the port's runs, mean
    and spread beside the JAX ones, and per metric the rule's judgement
    (``rules``: ``jax_reference.json``'s ``bound_rule``). Over other
    seeds than the rule's the leg is not judged (``checks``, ``passed``
    and ``failed_metrics`` None)."""
    set_name, scenario, _ = name.split("/")
    path = Path(fixtures) / set_name / f"{scenario}.npz"
    camera = fixture_camera(path, device)
    rule = rules[ref["rule"]]
    seeds = list(rule["seeds"] if seeds is None else seeds)
    before = {k: w.launches for k, w in kernels.WRAPPERS.items()}
    t0 = time.perf_counter()
    runs = []
    for seed in seeds:
        tracker = make_tracker(ref["config"], seed, camera, device)
        run = node.run(tracker, ReplaySource(str(path)))
        runs.append({"seed": seed, **run_metrics(run, scenario)})
        del tracker
    seconds = time.perf_counter() - t0
    jax_runs = [{k: r[k] for k in ("seed", *METRICS)} for r in ref["runs"]]
    checks = (judge(ref["rule"], rule, runs, jax_runs)
              if seeds == rule["seeds"] else None)
    failed = None if checks is None else [k for k in METRICS
                                          if checks[k]["failed"]]
    limit = rule.get("report_over_m")
    return {"set": set_name, "scenario": scenario,
            "estimator": ref["estimator"], "frames": ref["frames"],
            "particles": ref["particles"], "rule": ref["rule"],
            "seeds": seeds, "runs": runs, "jax_runs": jax_runs,
            "mean": {k: float(_sample(runs, k).mean()) for k in METRICS},
            "sd": {k: (float(_sample(runs, k).std(ddof=1))
                       if len(runs) > 1 else None) for k in METRICS},
            "jax_mean": {k: ref["mean"][k] for k in METRICS},
            "jax_sd": {k: ref["sd"][k] for k in METRICS},
            "checks": checks,
            "over_2cm": (None if limit is None else {
                side: int((_sample(rs, "pos_max_m") > limit).sum())
                for side, rs in (("port", runs), ("jax", jax_runs))}),
            "passed": None if failed is None else not failed,
            "failed_metrics": failed,
            "launches": {k: w.launches - before[k]
                         for k, w in kernels.WRAPPERS.items()},
            "seconds": seconds}


def run_set(fixtures, set_name: str, device=None, legs=None, seeds=None,
            on_leg=None) -> dict:
    """Every leg of ``set_name`` (or only those named in ``legs``) →
    ``{"legs": {name: result}, "passed", "seconds"}`` (``passed`` False
    if a leg failed, else None if a leg was not judged). ``device`` None
    is the card; ``on_leg(name, result)`` is called after each leg."""
    device = resolve_device(device)
    ref = load_reference(fixtures)
    t0 = time.perf_counter()
    out = {}
    for name, entry in ref["legs"].items():
        if entry["set"] != set_name or (legs is not None
                                        and name not in legs):
            continue
        out[name] = run_leg(fixtures, name, entry, ref["bound_rule"],
                            device, seeds)
        if on_leg is not None:
            on_leg(name, out[name])
    verdicts = [r["passed"] for r in out.values()]
    return {"set": set_name, "device": str(device),
            "jax_commit": ref["jax_commit"], "legs": out,
            "passed": (False if False in verdicts else
                       None if None in verdicts else True),
            "seconds": time.perf_counter() - t0}


def _seed_range(text):
    a, _, b = text.partition("-")
    return list(range(int(a), int(b or a) + 1))


def _fmt(x):
    return "—" if x is None else f"{x:.5f}"


def _show(name, r):
    verdict = ("not judged" if r["passed"] is None else "ok"
               if r["passed"] else "FAILS " + ",".join(r["failed_metrics"]))
    parts = []
    for k, label in (("pos_rmse_m", "pos"), ("rot_rmse_rad", "rot"),
                     ("pos_max_m", "max")):
        c = (r["checks"] or {}).get(k, {})
        parts.append(f"{label} {_fmt(r['mean'][k])} (JAX "
                     f"{_fmt(r['jax_mean'][k])}, slack "
                     f"{_fmt(c.get('slack'))})")
    over = ("" if r["over_2cm"] is None else
            f"  over 2 cm: port {r['over_2cm']['port']}, JAX "
            f"{r['over_2cm']['jax']}")
    print(f"{name:32s} " + "  ".join(parts) + f"{over}  {verdict}  "
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
    ap.add_argument("--seeds", type=_seed_range,
                    help="tracker seeds A-B in place of each leg's rule's "
                         "(a leg's spread over other seeds): a leg whose "
                         "rule has other seeds is not judged")
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
