"""The port's accuracy suite (dbot_ros_tpu_torch/runtime/eval_suite.py)
against the JAX tracker on the same frames, on the CPU.

* The fixtures are fresh: the JAX ``OracleSource`` re-renders the first
  frames of two scenes (from ``tests/torch_eval_reference.py``'s
  definitions) bit for bit, every frame file is the one the rule was
  fixed on, and the JAX runs of seeds 1-3 are the ones of the three-seed
  reference; the files hold every leg with its rule's seeds and stay
  within their size.
* The rule: a one-sided Welch test of non-inferiority for the particle
  filters (its verdicts on samples made here, its refusals, its
  quantile against scipy's), the floor over JAX's mean for the
  deterministic Gaussian filter (the bounds it had before the
  two-sample test came).
* The port's metrics equal the JAX ``TrackRun``'s (1e-6) on a fixture's
  ground truth against perturbed poses, the box's symmetry included.
* The port's filter step equals the JAX step on a fixture's frames when
  it is fed JAX's draws (the legs differ by their random streams only).
* The port's ``pf-pallas`` tracker on the ``eval`` set's nominal,
  occluder and dropout scenes, seeds 1-10, passes the rule, and a
  transition too stiff for ``fast_rot`` fails it (the ``pf-xla`` and
  ``pf-deferred`` legs take minutes a leg here and run on the card, in
  chip_smoke.py's ``eval`` phase).
"""

import copy
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from dbot_ros_tpu.runtime import node as jnode
from dbot_ros_tpu_torch.runtime import eval_suite
from dbot_ros_tpu_torch.runtime import node
from tests import torch_eval_reference as reference
from tests.test_torch_tracker import assert_beliefs_match

torch.set_num_threads(1)

FIXTURES = reference.FIXTURES


@pytest.fixture(scope="module")
def ref():
    return eval_suite.load_reference(FIXTURES)


@pytest.mark.parametrize("set_name,scenario", [("eval", "occluder"),
                                               ("production", "dropout")])
def test_fixture_frames_are_the_jax_renders(set_name, scenario):
    """Frames 0-2 rendered again by the JAX package equal the fixture's
    bit for bit (NaN where it has NaN), and so do their poses."""
    depth, poses = reference.render_frames(set_name, scenario, frames=3)
    data = np.load(reference.fixture_path(set_name, scenario))
    np.testing.assert_array_equal(depth, data["depth"][:3])
    np.testing.assert_array_equal(poses, data["poses"][:3])
    cam = reference.tracker_camera(set_name)
    np.testing.assert_array_equal(data["camera_matrix"],
                                  np.asarray(cam.camera_matrix, np.float32))
    assert (int(data["height"]), int(data["width"])) == (cam.height,
                                                         cam.width)


# the frame files the rule was fixed on (sha256)
FIXTURE_SHA256 = {
    "eval/dropout":
        "bbdf34b0709e881cc191d315c4b51b2cc1ca91826c1f8e36dd1763b92ca905a3",
    "eval/fast_rot":
        "a1aed50bd0ef2951f12b890ff6298d70afd58f2904affc848196301edee144dd",
    "eval/nominal":
        "1a06d86c56824fc12d6235e7e793a35ac7f6c2bfe09110bd08ae98b95a467682",
    "eval/occluder":
        "66312a470b5b51144787f4ca8d81c123c3948b466eca15efbd0784442cb30e5b",
    "eval/sensor_u16":
        "748c1e81bad6801bac5ed6d4c200a5f746400863a5cdb26c5d75986458750c7b",
    "eval/two_obj":
        "095e1879b55a98265aa10dd917de50c9ebfbc2fd823efea671c622f5e2d25e56",
    "production/dropout":
        "845294e3c58e2a747754ae8977a81e5133b1198b66d981abbcbe0ec2ad2a1e99",
    "production/fast_rot":
        "b5ff9e6429259ba88ee25cfe3b0a7cf64a8aef49b5dfb273b9d0f958745378d8",
    "production/nominal":
        "f14df3b76a5036d12b18c8ced26745263375a871dd3913502f00976b120c8c3a",
    "production/occluder":
        "0d59800ca087f2fb675fd4b444e3aea803639367ac7df198c35e2e40ca6efaa4",
}
# the JAX runs of seeds 1-3 in the three-seed reference, (pos_rmse_m,
# rot_rmse_rad, pos_max_m) per seed: the JAX side on the CPU is
# deterministic, so seeds 1-3 of the ten-seed reference are these runs
THREE_SEED_RUNS = {
    "production/occluder/pf-pallas": [
        (0.013254985213279724, 0.0939953550696373, 0.00954846478998661),
        (0.004353470169007778, 0.053110118955373764, 0.012279263697564602),
        (0.005671511869877577, 0.054197948426008224, 0.013278844766318798)],
    "eval/nominal/pf-xla": [
        (0.0022924409713596106, 0.054081376641988754, 0.004962742794305086),
        (0.0022442524787038565, 0.04704691097140312, 0.003908935002982616),
        (0.0023837413173168898, 0.0665818378329277, 0.005239751189947128)],
    "eval/dropout/pf-deferred": [
        (0.0050181010738015175, 0.12224608659744263, 0.009168996475636959),
        (0.004587586037814617, 0.10616955906152725, 0.008936486206948757),
        (0.008378366939723492, 0.13765202462673187, 0.009364784695208073)],
}
# the Gaussian legs' bounds in the three-seed reference (pos_rmse_m,
# rot_rmse_rad, pos_max_m; None: no gate)
THREE_SEED_RGF_BOUNDS = {
    "production/nominal/rgf": (0.003270328113809228, 0.04694866061210633,
                               0.02),
    "production/occluder/rgf": (0.0062614714950323105, 0.08860115379095078,
                                None),
    "eval/nominal/rgf": (0.0042293847762048245, 0.05073818422853947, 0.02),
    "eval/occluder/rgf": (0.005970951471477747, 0.05876520693302155, 0.02),
    "eval/dropout/rgf": (0.004764924127608538, 0.05924069553613663, 0.02),
    "eval/fast_rot/rgf": (0.0033873932659626007, 0.060334720164537434,
                          0.02),
    "eval/two_obj/rgf": (0.005643884487450123, 0.10935642987489701, 0.02),
    "eval/sensor_u16/rgf": (0.0037164763305336237, 0.06411913454532624,
                            0.02),
}


def test_fixtures_hold_every_leg_with_its_bound(ref):
    """30 legs (24 ``eval``, 4 PF and 2 Gaussian ``production``), each
    with its rule's seeds (1-10 for the 22 particle-filter legs, 1-3 for
    the 8 Gaussian ones, whose spread is 0), a run per seed whose mean
    and spread are the stored ones; ``bound_rule`` holds the rule as it
    was fixed; the frames' shapes; the directory within 8 MB."""
    legs = ref["legs"]
    assert list(legs) == reference.leg_names() and len(legs) == 30
    rules = ref["bound_rule"]
    assert rules == reference.bound_rule()
    pf = rules["two_sample"]
    assert pf["seeds"] == list(range(1, 11)) and pf["alpha"] == 0.001
    assert pf["t"] == 4.297 and pf["df"] == 9
    assert pf["margin"] == {"pos_rmse_m": 0.001, "rot_rmse_rad": 0.02,
                            "pos_max_m": 0.002}
    assert rules["deterministic"]["seeds"] == [1, 2, 3]
    assert rules["deterministic"]["floor"] == {"pos_rmse_m": 0.001,
                                               "rot_rmse_rad": 0.02}
    assert rules["deterministic"]["pos_max_limit_m"] == 0.02
    counts = {"two_sample": 0, "deterministic": 0}
    for name, leg in legs.items():
        counts[leg["rule"]] += 1
        assert leg["estimator"] in rules[leg["rule"]]["estimators"]
        assert leg["seeds"] == rules[leg["rule"]]["seeds"]
        assert [r["seed"] for r in leg["runs"]] == leg["seeds"]
        assert leg["config"] == reference.leg_config(name)
        assert "bound" not in leg and "sd_from" not in leg
        for k in leg["mean"]:
            v = np.array([r[k] for r in leg["runs"]])
            np.testing.assert_allclose(leg["mean"][k], v.mean(), rtol=1e-12)
            np.testing.assert_allclose(leg["sd"][k], v.std(ddof=1),
                                       rtol=1e-12, atol=0)
            if leg["rule"] == "deterministic":
                assert leg["sd"][k] == 0.0
    assert counts == {"two_sample": 22, "deterministic": 8}
    assert ref["jax_commit"]
    for set_name, n_frames, shape in (("eval", 45, (30, 40)),
                                      ("production", 60, (60, 80))):
        for scenario in ref["sets"][set_name]["scenarios"]:
            data = np.load(reference.fixture_path(set_name, scenario))
            assert data["depth"].shape == (n_frames, *shape)
            assert data["depth"].dtype == np.float32
            k = 2 if scenario == "two_obj" else 1
            assert data["poses"].shape == (n_frames, k, 7)


def test_reference_keeps_the_three_seed_runs_and_frames(ref):
    """Seeds 1-3 of the ten-seed reference are the three-seed
    reference's runs (1e-6 relative; three legs, one of them the
    production occluder leg); every frame file is byte for byte the one
    the rule was fixed on; the directory stays within 8 MB."""
    for name, runs in THREE_SEED_RUNS.items():
        got = [(r["pos_rmse_m"], r["rot_rmse_rad"], r["pos_max_m"])
               for r in ref["legs"][name]["runs"][:3]]
        assert [r["seed"] for r in ref["legs"][name]["runs"][:3]] == [1, 2, 3]
        np.testing.assert_allclose(got, runs, rtol=1e-6, atol=0,
                                   err_msg=name)
    sizes = os.path.getsize(reference.REFERENCE)
    for key, digest in FIXTURE_SHA256.items():
        path = reference.fixture_path(*key.split("/"))
        with open(path, "rb") as fh:
            assert hashlib.sha256(fh.read()).hexdigest() == digest, key
        sizes += os.path.getsize(path)
    assert len(FIXTURE_SHA256) == sum(
        len(s["scenarios"]) for s in ref["sets"].values())
    assert sizes <= 8 * 2 ** 20


def test_rule_t_is_students_quantile():
    """T is the one-sided 0.999 quantile of Student's t at the
    conservative Welch df, min(n_p, n_j) − 1 = 9 (1e-3)."""
    stats = pytest.importorskip("scipy.stats")
    rule = reference.bound_rule()["two_sample"]
    assert rule["df"] == len(rule["seeds"]) - 1 == 9
    assert abs(rule["t"] - stats.t.ppf(1 - rule["alpha"], rule["df"])) \
        < 1e-3


def samples(seed, n=10, shift=None):
    """Two samples of ``n`` runs with the spread of a PF leg: JAX's and
    the port's, the port's metrics moved by ``shift`` (metric → m)."""
    g = np.random.default_rng(seed)
    centre = {"pos_rmse_m": 0.005, "rot_rmse_rad": 0.1, "pos_max_m": 0.012}
    spread = {"pos_rmse_m": 0.0015, "rot_rmse_rad": 0.02,
              "pos_max_m": 0.004}

    def draw(moved):
        return [{"seed": s + 1, **{k: centre[k] + spread[k] * g.normal()
                                   + (moved or {}).get(k, 0.0)
                                   for k in eval_suite.METRICS}}
                for s in range(n)]
    return draw(shift), draw(None)


def se(runs, jax_runs, k):
    p = np.array([r[k] for r in runs])
    j = np.array([r[k] for r in jax_runs])
    return np.sqrt(p.var(ddof=1) / len(p) + j.var(ddof=1) / len(j))


@pytest.mark.parametrize("case", [
    "identical", "pos_rmse_m over", "rot_rmse_rad over", "pos_max_m over",
    "pos_rmse_m within", "rot_rmse_rad within", "pos_max_m within",
    "better"])
def test_two_sample_rule_judges(case):
    """With the samples' own difference taken out: identical samples
    pass; a port sample shifted by δ + 6·SE in one metric fails that
    metric only; shifted by 0.9·δ it passes; a port better than JAX by
    δ/2 passes with slack above the threshold."""
    rule = reference.bound_rule()["two_sample"]
    runs, jax_runs = samples(3)
    metric, _, kind = case.partition(" ")
    if case == "identical":
        runs = copy.deepcopy(jax_runs)
    for k in eval_suite.METRICS:
        # the port's mean on JAX's, then moved by the case's shift
        gap = (np.mean([r[k] for r in runs])
               - np.mean([r[k] for r in jax_runs]))
        move = (-0.5 * rule["margin"][k] if kind == "" and case == "better"
                else 0.0 if k != metric
                else rule["margin"][k] + 6 * se(runs, jax_runs, k)
                if kind == "over" else 0.9 * rule["margin"][k])
        for r in runs:
            r[k] += move - gap
    checks = eval_suite.judge("two_sample", rule, runs, jax_runs)
    failed = [k for k, c in checks.items() if c["failed"]]
    assert failed == ([metric] if kind == "over" else [])
    for k, c in checks.items():
        assert c["threshold"] == pytest.approx(
            rule["margin"][k] + rule["t"] * se(runs, jax_runs, k))
        assert c["slack"] == pytest.approx(c["threshold"] - c["diff"])
        if case == "identical":
            assert c["diff"] == 0.0
        if case == "better":
            assert c["slack"] > c["threshold"]


@pytest.mark.parametrize("case", ["one seed", "nine seeds", "port flat",
                                  "JAX flat"])
def test_two_sample_rule_refuses_a_sample_it_cannot_judge(case):
    """A sample of one seed, or of other than the rule's ten, or one
    without spread on either side raises instead of judging."""
    rule = reference.bound_rule()["two_sample"]
    runs, jax_runs = samples(4)
    if case == "one seed":
        runs = runs[:1]
    elif case == "nine seeds":
        jax_runs = jax_runs[:9]
    else:
        flat = runs if case == "port flat" else jax_runs
        for r in flat:
            r["rot_rmse_rad"] = 0.1
    with pytest.raises(ValueError):
        eval_suite.judge("two_sample", rule, runs, jax_runs)


@pytest.mark.parametrize("name", list(THREE_SEED_RGF_BOUNDS))
def test_gaussian_legs_keep_their_three_seed_bound(ref, name):
    """A Gaussian leg's rule is the bound it had before the two-sample
    rule, to the last bit: a port run at that bound passes, one float
    step above it fails, and the worst error has no gate where JAX's
    mean is over 2 cm."""
    leg = ref["legs"][name]
    rule = ref["bound_rule"][leg["rule"]]
    assert leg["rule"] == "deterministic" and leg["seeds"] == [1, 2, 3]
    jax_runs = [{m: r[m] for m in ("seed", *eval_suite.METRICS)}
                for r in leg["runs"]]
    old = dict(zip(eval_suite.METRICS, THREE_SEED_RGF_BOUNDS[name]))
    at = {k: 1.0 if b is None else b for k, b in old.items()}
    above = {k: 1.0 if b is None else float(np.nextafter(b, 1.0))
             for k, b in old.items()}
    passing = eval_suite.judge(leg["rule"], rule, [at], jax_runs)
    failing = eval_suite.judge(leg["rule"], rule, [above], jax_runs)
    for k, b in old.items():
        if b is None:
            assert passing[k]["threshold"] is None
            assert not passing[k]["failed"] and not failing[k]["failed"]
            continue
        assert leg["mean"][k] + passing[k]["threshold"] == pytest.approx(
            b, rel=1e-12)
        assert not passing[k]["failed"] and failing[k]["failed"]


def perturbed(truth, seed, flip_box):
    """The truth with 2-6 mm and 0.01-0.1 rad errors; with ``flip_box``
    object 1 also turned by π about its z axis on odd frames (the same
    pose up to the box's symmetry)."""
    g = np.random.default_rng(seed)
    est = truth.astype(np.float64).copy()
    est[..., :3] += g.uniform(0.002, 0.006, est[..., :3].shape) * \
        g.choice([-1, 1], est[..., :3].shape)
    dq = np.concatenate([np.ones(est.shape[:-1] + (1,)),
                         g.uniform(-0.05, 0.05, est.shape[:-1] + (3,))], -1)
    est[..., 3:] = quat_mul(est[..., 3:], dq)
    if flip_box:
        est[1::2, 1, 3:] = quat_mul(est[1::2, 1, 3:],
                                    np.array([0.0, 0.0, 0.0, 1.0]))
    est[..., 3:] /= np.linalg.norm(est[..., 3:], axis=-1, keepdims=True)
    return est.astype(np.float32)


def quat_mul(a, b):
    aw, ax, ay, az = np.moveaxis(np.broadcast_to(a, np.broadcast_shapes(
        a.shape, b.shape)), -1, 0)
    bw, bx, by, bz = np.moveaxis(np.broadcast_to(b, np.broadcast_shapes(
        a.shape, b.shape)), -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], -1)


@pytest.mark.parametrize("set_name,scenario", [("eval", "nominal"),
                                               ("eval", "two_obj"),
                                               ("production", "fast_rot")])
def test_port_metrics_equal_the_jax_track_run(set_name, scenario):
    """``eval_suite.run_metrics`` on the port's ``TrackRun`` against the
    reference script's metrics on the JAX ``TrackRun`` of the same poses
    (1e-6): RMSE, the worst position error over frames ≥ F//3, and for
    ``two_obj`` the rotation modulo the box's symmetry and the naive one
    (which the flips make differ)."""
    truth = np.load(reference.fixture_path(set_name, scenario))["poses"]
    est = perturbed(truth, 7, flip_box=scenario == "two_obj")
    port = eval_suite.run_metrics(node.TrackRun(est, None, truth), scenario)
    jax = reference.leg_metrics(jnode.TrackRun(est, None, truth), scenario,
                                len(truth))
    assert port.keys() == jax.keys()
    for k in port:
        np.testing.assert_allclose(port[k], jax[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    if scenario == "two_obj":
        assert port["rot_rmse_naive"] > port["rot_rmse_rad"] + 0.5


def test_port_step_equals_jax_on_fixture_frames_with_jax_draws():
    """The ``eval/nominal/pf-pallas`` leg's tracker, seed 1, in both
    packages over the fixture's first 8 frames, the port's step fed the
    draws the JAX step takes from its key: states, weights, maps, means
    equal frame after frame (a particle may take the neighbouring parent
    at a CDF tie, ``assert_beliefs_match``). What separates the two legs'
    results is then the random stream alone."""
    for pbel, pinfo, ps, jbel, jinfo, js in reference.lockstep(
            "eval/nominal/pf-pallas", 1, 8):
        assert bool(pinfo.resampled) == bool(jinfo.resampled)
        assert_beliefs_match(pbel, pinfo, ps, jbel, jinfo, js)


def test_port_xla_step_equals_jax_on_fixture_frames_with_jax_draws():
    """The same for ``eval/nominal/pf-xla`` (seed 2, the fixture's first
    3 frames: ~5 s a frame here), the leg whose mean over seeds 1-3 is
    over its bound on the card: fed JAX's draws, the port's step is
    JAX's."""
    for pbel, pinfo, ps, jbel, jinfo, js in reference.lockstep(
            "eval/nominal/pf-xla", 2, 3):
        assert bool(pinfo.resampled) == bool(jinfo.resampled)
        assert_beliefs_match(pbel, pinfo, ps, jbel, jinfo, js)


@pytest.mark.parametrize("scenario", ["nominal", "occluder", "dropout"])
def test_port_pallas_legs_meet_their_bounds_on_the_cpu(ref, scenario):
    """The port's fused-sensor tracker (plain kernels on the CPU) over
    its rule's seeds 1-10 on the JAX tracker's frames passes the rule
    against JAX's ten seeds in every metric."""
    name = f"eval/{scenario}/pf-pallas"
    res = eval_suite.run_leg(FIXTURES, name, ref["legs"][name],
                             ref["bound_rule"], "cpu")
    assert res["seeds"] == list(range(1, 11)) and len(res["runs"]) == 10
    assert res["rule"] == "two_sample"
    assert res["passed"] and res["failed_metrics"] == [], res["checks"]
    assert all(c["slack"] > 0 for c in res["checks"].values())
    assert set(res["over_2cm"]) == {"port", "jax"}
    assert set(res["launches"].values()) == {0}      # plain on the CPU


def test_a_stiff_transition_fails_the_rule_on_the_cpu(ref):
    """The eval phase's power check, on the CPU: ``eval/fast_rot/
    pf-pallas`` with both transition sigmas × 0.1 (a belief too stiff to
    follow the rotation) fails the rule against JAX's real leg."""
    import chip_smoke

    name = chip_smoke.EVAL_POWER_LEG
    stiff = chip_smoke.stiff_leg(ref["legs"][name])
    assert stiff["config"]["transition"] == pytest.approx(
        {"linear_acceleration_sigma": 0.04,
         "angular_acceleration_sigma": 0.6, "damping": 6.0})
    res = eval_suite.run_leg(FIXTURES, name, stiff, ref["bound_rule"],
                             "cpu")
    assert res["passed"] is False and res["failed_metrics"], res["checks"]


def test_suite_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """The default device is the card: without CUDA the entry point
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_suite.main(["--fixtures", FIXTURES, "--set", "eval",
                         "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def test_other_seeds_are_not_judged(ref, tmp_path):
    """The rule holds the samples over seeds 1-10: over other seeds the
    entry point prints means and spreads, judges no leg and exits 0."""
    name = "eval/nominal/pf-pallas"
    out = tmp_path / "r.json"
    assert eval_suite.main(["--fixtures", FIXTURES, "--device", "cpu",
                            "--legs", name, "--seeds", "11-12",
                            "--out", str(out)]) == 0
    res = json.loads(out.read_text())["eval"]
    assert res["passed"] is None
    leg = res["legs"][name]
    assert leg["seeds"] == [11, 12] and len(leg["runs"]) == 2
    assert leg["passed"] is None and leg["failed_metrics"] is None
    assert leg["checks"] is None
    assert leg["jax_mean"] == {k: ref["legs"][name]["mean"][k]
                               for k in eval_suite.METRICS}
