"""A scene of several tracked objects: a two-object configuration, its
mix and its cell, added as new files and entries alone, run on the CPU
and checked against the coordinate particle filter's reference; three
faults of the coordinate blocks and two of block 0's resampling come
out not correct; a cell whose configuration and mix count different
objects, or more than two, is refused."""

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.core import runner, spec, traffic
from portbench.reference import scene

ROOT = Path(__file__).resolve().parents[2]
# the eval suite's box (benchmarks/eval_suite.py), tracked beside the
# benchmark's ellipsoid
BOX = {"kind": "box", "size_m": [0.05, 0.07, 0.03], "triangles": 12,
       "padded_triangles": 128}
# the box crosses in front of the ellipsoid, once each way a period
# (±12 cm across at 0.66 m, ≤ 3.8 cm/s over a 600-frame period); its
# corners stay 5 mm before the ellipsoid's nearest point
BOX_MOTION = {
    "depth_m": 0.8,
    "offset_m": [0.0, 0.01, -0.14],
    "translation": {"amplitude_m": [0.12, 0.01, 0.01],
                    "harmonics": [1, 2, 1]},
    "rotation": {"kind": "sway", "base_rad": 0.5,
                 "amplitude_rad": [0.3, 0.3, 0.3], "harmonics": [1, 2, 1]},
}
CELL = "two.stream"
# a test-sized run: the CPU tracks 512 particles in tens of ms a block
PARTICLES = 512
PERIOD = {"period_frames": 120, "warmup_frames": 8}
# the test's limits: sound CPU runs of this scene at 512 particles read
# at most 0.0138 mm, 0.103 mrad and 0.194 mm/s over 21 seeds, the three
# faults of the blocks at least 0.19 mm, 1.15 mrad and 3.2 mm/s (PERF.md)
LIMITS = {"lateral_mm": 0.05, "rot_mrad": 0.4, "carry_lateral_mm": 0.05,
          "carry_rot_mrad": 0.4, "carry_velocity_mm_s": 1.2}
# and the two numbers a scene of two objects requires: block 0's recovered
# parents must give the carried proposals (to ~16 float32 ulps of a
# position) and lie on the reference's CDF; sound runs read 0 mm and at
# most 0.0034 of the weight over 21 seeds, block 1 unproposed at least
# 0.076 mm, block 0 not resampled or resampled from half the particles
# at least 0.028 of the weight (PERF.md)
PARENTS_LIMITS = {"parents_mm": 0.001, "parents_cdf": 0.01}


def two_object_files(particles=None, period=None):
    """(configuration, mix) of the two-object scene: the particle
    configuration with the ellipsoid and the box, and the stream mix
    with the box's motion beside the ellipsoid's; at ``particles``, the
    test's limits."""
    conf = spec.config("pf_rbcpf_10k")
    conf["assumed"]["meshes"] = [conf["assumed"].pop("mesh"), BOX]
    if particles:
        conf["settings"]["evaluation_count"] = particles
        conf["limits"] = {**LIMITS, **PARENTS_LIMITS}
    mix = spec.traffic("stream")
    mix["motions"] = [mix.pop("motion"), BOX_MOTION]
    mix.update(period or {})
    return conf, mix


def add_cell(root: Path, conf, mix, cell=CELL):
    """The configuration, the mix and the cell as new files and entries
    of the checkout at ``root``."""
    (root / "portbench/configs/two_objects.json").write_text(
        json.dumps(conf))
    (root / "portbench/traffic/two_stream.json").write_text(json.dumps(mix))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "two_objects", "source": "a test",
                         "file": "portbench/configs/two_objects.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": cell, "config": "two_objects",
                           "traffic": "two_stream", "chips": 1,
                           "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "pf10k.stream" in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def _copy_checkout(dest: Path):
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")


@pytest.fixture
def two_object_cell(tmp_path, monkeypatch):
    """The two-object cell in a copy of the benchmark's files, read by
    this process's ``spec``."""
    _copy_checkout(tmp_path)
    add_cell(tmp_path, *two_object_files(PARTICLES, PERIOD))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "PKG", tmp_path / "portbench")
    spec.bench.cache_clear()
    monkeypatch.setattr(runner, "CHECKS", 4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield CELL
    torch.set_num_threads(threads)
    spec.bench.cache_clear()


def test_a_two_object_cell_of_new_files_only(tmp_path):
    """The two-object configuration, its mix and its cell, added as new
    files and entries, run (traced) without touching a file that was
    there, and correct under the test's limits."""
    root = tmp_path
    _copy_checkout(root)
    (root / "dbot_ros_tpu_torch").symlink_to(ROOT / "dbot_ros_tpu_torch")
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    add_cell(root, *two_object_files(PARTICLES, PERIOD))
    code = (
        "import json, sys, torch\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "torch.set_num_threads(2)\n"
        "from portbench.core import runner\n"
        "runner.CHECKS = 4\n"
        f"out = runner.run_cell({CELL!r}, 2**33 + 77, 3.0, True,\n"
        "                      device='cpu', log=lambda m: None)\n"
        "print(json.dumps(out))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["info"]["checked_frames"] >= 2
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(LIMITS) | set(PARENTS_LIMITS)
    assert res["failed"] == 0
    assert res["metrics"]["trackers.track_ms_p50"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


@contextlib.contextmanager
def _patched(module, name, fn):
    real = getattr(module, name)
    setattr(module, name, fn(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _resampling_fault(fault):
    """A fault of block 0's resampling, patched into the port's filter:
    no resampling at all, or systematic resampling over the first half
    of the particles alone."""
    from dbot_ros_tpu_torch.filters import rbcpf

    if fault == "not_resampled":
        return _patched(rbcpf, "weigh_block", lambda real: (
            lambda *a, **k: real(*a[:6], rbcpf.NEVER_RESAMPLE_KL, *a[7:],
                                 **k)))
    return _patched(rbcpf.rs, "systematic_indices", lambda real: (
        lambda log_w, n, **k: real(log_w[..., :log_w.shape[-1] // 2], n,
                                   **k)))


BLOCK0_FAULTS = ("not_resampled", "half_the_particles")


def _object_fault(fault):
    """A particle tracker with one fault of a scene of two objects."""
    from dbot_ros_tpu_torch.filters import rbcpf
    from dbot_ros_tpu_torch.trackers.particle import ParticleTracker

    class Faulty(ParticleTracker):
        def _block(self, prog, b, bel, z, dt, nb):
            if fault in BLOCK0_FAULTS:
                if b != 0:
                    return super()._block(prog, b, bel, z, dt, nb)
                with _resampling_fault(fault):
                    return super()._block(prog, b, bel, z, dt, nb)
            if b != 1 or fault == "swapped":
                return super()._block(prog, b, bel, z, dt, nb)
            if fault == "unproposed":
                patch = _patched(rbcpf, "propose_block", lambda real: (
                    lambda states, *a, **k: states.clone()))
            else:                                    # "no_telescope"
                patch = _patched(rbcpf, "weigh_block", lambda real: (
                    lambda belief, loglik, occ_post, old, *a, **k: real(
                        belief, loglik, occ_post, torch.zeros_like(old),
                        *a, **k)))
            with patch:
                return super()._block(prog, b, bel, z, dt, nb)

        def track(self, depth_image, dt=None):
            poses, info = super().track(depth_image, dt)
            if fault == "swapped":
                poses = poses.clone()
                poses[0] = poses[1]
            return poses, info

    def make(kind, settings, device):
        from dbot_ros_tpu_torch import config as cfg
        return Faulty(cfg.particle_config_from_dict(settings),
                      device=device)
    return make


@pytest.mark.parametrize("fault", ["unproposed", "no_telescope",
                                   "swapped", *BLOCK0_FAULTS])
def test_a_broken_coordinate_block_is_not_correct(two_object_cell, fault):
    """Block 1 never proposed; the telescoping ``- old`` dropped; object
    1's pose published as object 0's; block 0 not resampled, or
    resampled from half the particles."""
    out = runner.run_cell(two_object_cell, 41_000_000_003, 3.0, False,
                          device="cpu", tracker_factory=_object_fault(fault),
                          log=lambda m: None)
    assert out["info"]["checked_frames"] >= 2
    assert out["correct"] is False, out["checks"]


def test_object_zero_keeps_its_stream():
    """A mix of two objects gives object 0 the trajectory a one-object
    mix of the same motion gives it, object 1 one of its own, and a
    truth of (period, 2, 7); the box stays before the ellipsoid."""
    conf, mix = two_object_files(period={"period_frames": 30})
    cam = dict(conf["settings"]["camera"], downsampling_factor=16)
    objs = [scene.object_obj_text(m) for m in spec.meshes(conf)]
    two = traffic.make(mix, {"camera": cam}, objs, 2**33 + 5, "cpu")
    one_mix = dict(mix, motion=mix["motions"][0])
    del one_mix["motions"]
    one = traffic.make(one_mix, {"camera": cam}, objs[:1], 2**33 + 5, "cpu")
    assert two.truth.shape == (30, 2, 7) and one.truth.shape == (30, 7)
    assert two.objects == 2 and one.objects == 1
    assert np.array_equal(two.truth[:, 0], one.truth)
    assert two.poses(3).shape == (2, 7)
    assert np.array_equal(one.poses(3), one.truth[3:4])
    # nearer than the ellipsoid by more than the box's half-diagonal plus
    # the ellipsoid's largest semi-axis
    gap = two.truth[:, 0, 2] - two.truth[:, 1, 2]
    assert gap.min() > 0.0455 + 0.06
    x = two.truth[:, 1, 0] - two.truth[:, 0, 0]
    assert x.min() < -0.08 and x.max() > 0.08      # it crosses
    # the box hides part of the ellipsoid on some frames
    assert not np.array_equal(two.frames, one.frames)


def test_the_box_mesh():
    v_f = scene.object_mesh(scene.object_obj_text(BOX), False, "cpu")
    assert v_f.num_triangles == BOX["triangles"]
    assert v_f.padded_triangles == BOX["padded_triangles"]
    ext = v_f.vertices[:v_f.num_vertices].amax(0) - v_f.vertices[
        :v_f.num_vertices].amin(0)
    assert torch.allclose(ext, torch.tensor(BOX["size_m"]))


def test_an_offset_draws_nothing():
    params = spec.traffic("stream")["motion"]
    shifted = dict(params, offset_m=[0.01, -0.02, 0.03])
    a = scene.trajectory(params, np.random.default_rng(3), 50, 30.0)
    b = scene.trajectory(shifted, np.random.default_rng(3), 50, 30.0)
    assert np.allclose(b[:, :3] - a[:, :3], [0.01, -0.02, 0.03])
    assert np.array_equal(a[:, 3:], b[:, 3:])


@pytest.mark.parametrize("case", ["config_two_mix_one", "config_one_mix_two",
                                  "gaussian", "native", "both_keys",
                                  "three"])
def test_a_cell_that_counts_objects_twice_is_refused(case):
    conf, mix = two_object_files()
    one_conf = spec.config("pf_rbcpf_10k")
    one_mix = spec.traffic("stream")
    if case == "config_two_mix_one":
        pair, words = (conf, one_mix), "tracks 2 object(s) but the mix moves 1"
    elif case == "config_one_mix_two":
        pair, words = (one_conf, mix), "tracks 1 object(s) but the mix moves 2"
    elif case == "gaussian":
        conf["tracker"] = "gaussian"
        pair, words = (conf, mix), "only the particle tracker"
    elif case == "native":
        mix["resolution"] = "native"
        pair, words = (conf, mix), "the live path takes one object"
    elif case == "three":
        conf["assumed"]["meshes"].append(BOX)
        mix["motions"].append(BOX_MOTION)
        pair, words = (conf, mix), "a scene holds at most 2"
    else:
        conf["assumed"]["mesh"] = BOX
        pair, words = (conf, mix), "exactly one of 'mesh' and 'meshes'"
    with pytest.raises(ValueError, match=words.replace("(", r"\(").replace(
            ")", r"\)")):
        spec.objects(*pair)
    assert spec.objects(one_conf, one_mix) == 1
    assert spec.objects(*two_object_files()) == 2


def test_the_reference_steps_each_block_in_turn():
    """At K = 2 the reference proposes object b only in block b, draws
    (e1, e2, u) a block and reads both objects in the candidate table."""
    from portbench.reference import pf

    conf, mix = two_object_files(64)
    settings = dict(conf["settings"], seed=5)
    objs = [scene.object_obj_text(m) for m in spec.meshes(conf)]
    ref = pf.ParticleReference(settings, objs, "cpu")
    assert ref.K == 2 and ref.deg == 1408 + 128 - 1
    truth = traffic.make(dict(mix, period_frames=30), settings, objs, 9,
                         "cpu")
    bel = ref.initial(truth.poses(0))
    assert bel.states.shape == (64, 2, 13)
    draws = ref.draw(ref.generator())
    assert len(draws) == 2 and all(u is not None for _, _, u in draws)
    st = ref.step(bel, truth.frames[0], 1 / 30, draws)
    assert st.pose.shape == (2, 7) and torch.isfinite(st.pose).all()
    n_active, n_uniq = ref.candidate_counts(truth.poses(0))
    cand = ref.candidates(bel.states)
    assert bool((cand >= 1408).any() & (cand < 1408 + 12).any())
    assert n_uniq > 12 and n_active > 0
    # block 1 never moves object 0 and block 0 never moves object 1:
    # with object 1's draws zeroed, object 1 moves by its velocity alone
    quiet = [draws[0], (torch.zeros_like(draws[1][0]),
                        torch.zeros_like(draws[1][1]), draws[1][2])]
    st = ref.step(bel, truth.frames[0], 1 / 30, quiet)
    moved = st.belief.states[:, 1, :7] - bel.states[:, 1, :7]
    assert float(moved.abs().max()) < 1e-6
    assert float((st.belief.states[:, 0, :3]
                  - bel.states[:, 0, :3]).abs().max()) > 1e-5


def test_answers_of_an_ambiguous_kl(monkeypatch):
    """A block whose KL lies within rounding of the trigger forks: the
    step keeps every answer, 2^K where every block does, the step's own
    first."""
    from portbench.reference import pf

    conf, mix = two_object_files(64)
    settings = dict(conf["settings"], seed=5)
    objs = [scene.object_obj_text(m) for m in spec.meshes(conf)]
    ref = pf.ParticleReference(settings, objs, "cpu")
    truth = traffic.make(dict(mix, period_frames=30), settings, objs, 9,
                         "cpu")
    bel = ref.initial(truth.poses(0))
    draws = ref.draw(ref.generator())
    st = ref.step(bel, truth.frames[0], 1 / 30, draws)
    assert len(st.answers()) == 1
    monkeypatch.setattr(pf, "KL_AMBIGUITY", 1e9)
    forked = ref.step(bel, truth.frames[0], 1 / 30, draws)
    answers = forked.answers()
    assert len(answers) == 4
    assert all(dataclasses.is_dataclass(a) for a in answers)
    assert torch.equal(answers[0].pose, st.pose)
    assert len({tuple(a.pose.reshape(-1).tolist()) for a in answers}) > 1


@pytest.mark.parametrize("resampling", ["systematic", "half_the_particles"])
def test_the_recovered_parents_are_the_programs(resampling):
    """A program's block-0 parents, recovered from the particles it
    carried out of a step, are the parents it drew, its proposals match
    exactly, and the pairs lie on the reference's CDF; resampled from
    the half of the particles that holds less of the weight, they lie far
    from it."""
    from portbench.reference import pf
    from portbench.reference.frozen import resample as rs
    from portbench.reference.frozen.transition import sample_transition

    conf, mix = two_object_files(256)
    settings = dict(conf["settings"], seed=5)
    objs = [scene.object_obj_text(m) for m in spec.meshes(conf)]
    ref = pf.ParticleReference(settings, objs, "cpu")
    truth = traffic.make(dict(mix, period_frames=30), settings, objs, 9,
                         "cpu")
    bel = ref.initial(truth.poses(0))
    g = torch.Generator().manual_seed(3)
    bel.states[..., :3] += 0.003 * torch.randn(bel.states[..., :3].shape,
                                               generator=g)
    (e1, e2, u), nxt = ref.draw(ref.generator())
    dt = torch.tensor(1 / 30)
    z = scene.preprocess(torch.as_tensor(truth.frames[1]))
    states = bel.states.clone()
    states[:, 0] = sample_transition(bel.states[:, 0], dt, ref.trans,
                                     e1=e1, e2=e2)
    loglik, _ = ref.sense(states, bel.occ, bel.age, z, dt * 30)
    log_w = bel.log_weights + loglik
    half = resampling == "half_the_particles"
    if half:
        # the half that holds less of the weight
        w = rs.normalize_log_weights(log_w)[0].exp()
        at = 0 if float(w[:128].sum()) < 0.5 else 128
        parents = at + rs.systematic_indices(log_w[at:at + 128], 256, u=u)
    else:
        parents = rs.systematic_indices(log_w, 256, u=u).clamp(0, 255)
    moved = states[parents]
    moved[:, 1] = sample_transition(moved[:, 1], dt, ref.trans, e1=nxt[0],
                                    e2=nxt[1])
    # the program's last resampling keeps every third particle
    kept = torch.arange(0, 256, 3).repeat_interleave(3)[:256]
    idx, gap, off, unfixed, lo, hi = ref.recover_parents(
        log_w, u, states, 0, moved[kept], nxt, dt)
    assert gap == 0.0
    assert torch.equal(idx[kept], parents[kept])
    assert int((~unfixed).sum()) == kept.unique().numel()
    assert bool((lo <= idx).all() and (idx <= hi).all())
    if half:
        assert off > 0.25
    else:
        assert off < 1e-6
