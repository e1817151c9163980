"""The port's control service (``runtime/service.py``) and its wiring in
``node.run`` and ``track --service``, mirroring ``tests/test_service.py``
case by case with both of the port's trackers.

The protocol is the reference's: the same commands, replies and
``status`` fields. One case holds the port to the JAX package directly:
a command script submitted before ``node.run`` (a reset, a malformed
pose, a checkpoint to a path that cannot be written) and a shutdown
submitted after the third frame give the same ``status`` fields (all but
the pose values, which come from two different random streams) and stop
on the same frame. Sockets live in short ``tempfile.mkdtemp`` paths
(AF_UNIX allows 108 bytes); every connect, receive and join has a
timeout.
"""

import os
import shutil
import stat
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

from dbot_ros_tpu import config as jcfg
from dbot_ros_tpu.runtime import node as jnode
from dbot_ros_tpu.runtime import service as jservice
from dbot_ros_tpu.runtime import sources as jsources
from dbot_ros_tpu.trackers.particle import ParticleTracker as JaxTracker
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch.runtime import checkpoint, cli, node, sources
from dbot_ros_tpu_torch.runtime.service import TrackerService, call
from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
from dbot_ros_tpu_torch.utils import camera, mesh

torch.set_num_threads(1)

K32 = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
START = np.array([0.0, 0.0, 0.6, 1.0, 0, 0, 0], np.float32)
TRANSITION = dict(linear_acceleration_sigma=0.4,
                  angular_acceleration_sigma=2.0, damping=4.0)
# a search budget that runs in about a second on the CPU at 32×32
LEAN_SEARCH = dict(n_axes=2, n_spins=2, refine_particles=16,
                   refine_steps=1, polish_rounds=0)
TIMEOUT = 60.0
KINDS = ["particle", "gaussian"]


def trajectory(t):
    p = START.copy()
    p[0] += 0.01 * t / 30.0
    return p[None]


def make_scene(kind, frames):
    cam = camera.make_camera(K32, 32, 32)
    m = mesh.box_mesh(0.08, 0.06, 0.05)
    src = sources.SyntheticSource(m, cam, trajectory, num_frames=frames,
                                  noise_sigma=0.002, seed=0)
    tr = cfg.TransitionConfig(**TRANSITION)
    if kind == "particle":
        conf = cfg.ParticleTrackerConfig(
            evaluation_count=128, max_kl_divergence=0.8, backend="pallas",
            observation=cfg.ObservationConfig(model_sigma=0.005,
                                              sigma_factor=0.0),
            transition=tr, seed=3)
        tracker = ParticleTracker(conf, meshes=[m], camera=cam,
                                  device="cpu")
    else:
        tracker = GaussianTracker(cfg.GaussianTrackerConfig(
            transition=tr, seed=3), meshes=[m], camera=cam, device="cpu")
    return src, tracker


@pytest.fixture
def sock_dir():
    d = tempfile.mkdtemp(prefix="dbt")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def run_in_thread(fn):
    result = {}

    def target():
        try:
            result["value"] = fn()
        except BaseException as e:              # surfaced by the caller
            result["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t, result


def joined(t, result):
    t.join(TIMEOUT)
    assert not t.is_alive(), "worker did not finish in time"
    if "error" in result:
        raise result["error"]
    return result["value"]


# ------------------------------------------------------- programmatic API

def test_submit_queue_and_status_roundtrip():
    svc = TrackerService()
    st = svc.submit({"cmd": "status"})
    assert st["ok"] and st["frame"] is None and st["pending"] == 0
    assert svc.submit({"cmd": "pause"}) == {"ok": True, "paused": True}
    assert svc.paused
    assert svc.submit({"cmd": "resume"}) == {"ok": True, "paused": False}
    assert not svc.submit({"cmd": "reset_pose"})["ok"]       # no pose
    assert not svc.submit({"cmd": "checkpoint"})["ok"]       # no path
    r = svc.submit({"cmd": "reset_pose", "pose": START.tolist()})
    assert r == {"ok": True, "queued": True, "seq": 1}
    assert svc.status()["pending"] == 1
    assert not svc.submit({"cmd": "bogus"})["ok"]
    # the reference's replies, key for key, on fresh services
    for cmd in ({"cmd": "status"}, {"cmd": "pause"}, {"cmd": "resume"},
                {"cmd": "reset_pose"}, {"cmd": "checkpoint"},
                {"cmd": "bogus"}, {"cmd": "find_object"},
                {"cmd": "checkpoint", "path": "b.npz"},
                {"cmd": "shutdown"}):
        assert TrackerService().submit(dict(cmd)) == \
            jservice.TrackerService().submit(dict(cmd))


@pytest.mark.parametrize("kind", KINDS)
def test_reset_pose_applies_on_loop_thread(kind):
    src, tracker = make_scene(kind, frames=6)
    svc = TrackerService()
    wrong = [0.3, 0.3, 1.5, 1, 0, 0, 0]
    svc.submit({"cmd": "reset_pose", "pose": wrong})
    run = node.run(tracker, src, service=svc)
    # the reset fired before frame 0's step: the estimate starts near it
    assert np.linalg.norm(run.poses[0, 0, :3] - wrong[:3]) < 0.2
    assert svc.status()["applied_seq"] == 1
    assert svc.status()["frame"] == 5


@pytest.mark.parametrize("kind", KINDS)
def test_shutdown_stops_run_early(kind):
    src, tracker = make_scene(kind, frames=40)
    svc = TrackerService()
    count = {"n": 0}

    def on_frame(frame, poses, info):
        count["n"] += 1
        if count["n"] == 3:
            svc.submit({"cmd": "shutdown"})

    run = node.run(tracker, src, on_frame=on_frame, service=svc)
    assert len(run.poses) == 3                 # stops before frame 3
    assert svc.shutdown_requested


@pytest.mark.parametrize("kind", KINDS)
def test_pause_holds_playback_until_resume(kind):
    src, tracker = make_scene(kind, frames=8)
    svc = TrackerService()
    paused = threading.Event()

    def on_frame(frame, poses, info):
        if frame.index == 2:
            svc.submit({"cmd": "pause"})
            paused.set()

    def resumer():
        assert paused.wait(TIMEOUT)
        time.sleep(0.25)
        # still held on frame 2: the loop pulls no frame while paused
        assert svc.status()["frame"] == 2
        svc.submit({"cmd": "resume"})

    t, res = run_in_thread(resumer)
    run = node.run(tracker, src, on_frame=on_frame, service=svc)
    t.join(TIMEOUT)
    assert not t.is_alive() and "error" not in res, res.get("error")
    assert len(run.poses) == 8
    assert [m.frame for m in run.metrics.records] == list(range(8))


@pytest.mark.parametrize("kind", KINDS)
def test_shutdown_while_paused(kind):
    src, tracker = make_scene(kind, frames=8)
    svc = TrackerService()

    def on_frame(frame, poses, info):
        if frame.index == 1:
            svc.submit({"cmd": "pause"})
            threading.Timer(
                0.2, lambda: svc.submit({"cmd": "shutdown"})).start()

    run = node.run(tracker, src, on_frame=on_frame, service=svc)
    assert len(run.poses) == 2                 # frames 0-1 only


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_command_saves_belief_and_generator(kind, tmp_path):
    src, tracker = make_scene(kind, frames=5)
    svc = TrackerService()
    path = str(tmp_path / "belief.npz")
    at_command = {}

    def on_frame(frame, poses, info):
        if frame.index == 1:
            svc.submit({"cmd": "checkpoint", "path": path})
            # applied before frame 2's step, with the generator as it is
            # now: a restored tracker draws what this one drew next
            if kind == "particle":
                at_command["gen"] = tracker.generator.get_state().clone()

    node.run(tracker, src, on_frame=on_frame, service=svc)
    assert os.path.exists(path)
    assert svc.status()["last_error"] is None
    gen = torch.Generator()
    belief = checkpoint.load_belief(path, generator=gen)
    if kind == "particle":
        assert belief.states.shape == tracker.belief.states.shape
        assert torch.equal(gen.get_state(), at_command["gen"])
    else:
        assert belief.mean.shape == tracker.belief.mean.shape
        assert "generator_state" not in np.load(path)


@pytest.mark.parametrize("kind", KINDS)
def test_bad_command_does_not_kill_loop(kind):
    src, tracker = make_scene(kind, frames=4)
    svc = TrackerService()
    svc.submit({"cmd": "reset_pose", "pose": [0.0, 0.0, 0.6]})   # 3 != 7
    svc.submit({"cmd": "checkpoint", "path": "/nonexistent/dir/x.npz"})
    run = node.run(tracker, src, service=svc)
    assert len(run.poses) == 4
    st = svc.status()
    assert st["last_error"] and "seq 2" in st["last_error"]
    assert st["applied_seq"] == 2


@pytest.mark.parametrize("kind", KINDS)
def test_find_object_reacquires_on_the_loop_thread(kind):
    src, tracker = make_scene(kind, frames=6)
    svc = TrackerService()

    def on_frame(frame, poses, info):
        if frame.index == 1:
            svc.submit({"cmd": "find_object"})

    run = node.run(tracker, src, on_frame=on_frame, service=svc,
                   reinit_kwargs=LEAN_SEARCH)
    assert run.reinit_frames == [2] == svc.status()["reinit_frames"]
    assert len(run.reinit_seconds) == 1 and run.reinit_seconds[0] > 0
    assert svc.status()["applied_seq"] == 1
    err = np.linalg.norm(run.poses[-1, 0, :3] - trajectory(5)[0, :3])
    assert err < 0.05, err


# ------------------------------------------------------------- unix socket

@pytest.mark.parametrize("kind", KINDS)
def test_socket_service_end_to_end(kind, sock_dir):
    sock = os.path.join(sock_dir, "t.sock")
    src, tracker = make_scene(kind, frames=60)
    svc = TrackerService(sock)
    try:
        t, res = run_in_thread(lambda: node.run(tracker, src, service=svc))
        deadline = time.time() + TIMEOUT
        st = {}
        while time.time() < deadline:
            st = call(sock, {"cmd": "status"}, timeout=5.0)
            if st.get("frame") is not None and st["frame"] >= 2:
                break
            time.sleep(0.02)
        assert st.get("frame", -1) >= 2
        assert st["ok"] and len(st["poses"][0]) == 7
        assert call(sock, {"cmd": "bogus"}, timeout=5.0)["ok"] is False
        r = call(sock, {"cmd": "shutdown"}, timeout=5.0)
        assert r["ok"] and r["queued"]
        run = joined(t, res)
        assert len(run.poses) < 60
    finally:
        svc.close()
    assert not os.path.exists(sock)


def test_serve_refuses_live_socket_and_reclaims_stale(sock_dir):
    path = os.path.join(sock_dir, "c.sock")
    svc = TrackerService(path)
    try:
        assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
        with pytest.raises(RuntimeError, match="in use"):
            TrackerService(path)
        # a JAX client speaks the same protocol
        assert jservice.call(path, {"cmd": "status"}, timeout=5.0)["ok"]
    finally:
        svc.close()
    with open(path, "a"):
        pass                              # a stale file at the path
    svc2 = TrackerService(path)
    svc2.close()
    assert not os.path.exists(path)


# ------------------------------------------------- against the JAX package

def command_script(svc, tmp):
    """The same script for both packages: submitted before node.run."""
    svc.submit({"cmd": "reset_pose", "pose": trajectory(0)[0].tolist()})
    svc.submit({"cmd": "reset_pose", "pose": [0.0, 0.0, 0.6]})
    svc.submit({"cmd": "checkpoint",
                "path": os.path.join(tmp, "no", "such", "dir", "b.npz")})

    def on_frame(frame, poses, info):
        if frame.index == 2:
            svc.submit({"cmd": "shutdown"})

    return on_frame


def test_command_script_gives_the_status_of_jax(tmp_path):
    jcam = jcamera.make_camera(K32, 32, 32)
    jm = jmesh.box_mesh(0.08, 0.06, 0.05)
    jsrc = jsources.SyntheticSource(jm, jcam, trajectory, num_frames=8,
                                    noise_sigma=0.002, seed=0)
    jconf = jcfg.ParticleTrackerConfig(
        evaluation_count=128, max_kl_divergence=0.8,
        observation=jcfg.ObservationConfig(model_sigma=0.005,
                                           sigma_factor=0.0),
        transition=jcfg.TransitionConfig(**TRANSITION), seed=3)
    jsvc = jservice.TrackerService()
    jrun = jnode.run(JaxTracker(jconf, meshes=[jm], camera=jcam), jsrc,
                     on_frame=command_script(jsvc, str(tmp_path)),
                     service=jsvc)
    want = jsvc.status()

    src, tracker = make_scene("particle", frames=8)
    svc = TrackerService()
    run = node.run(tracker, src, on_frame=command_script(svc, str(tmp_path)),
                   service=svc)
    got = svc.status()
    assert len(run.poses) == len(jrun.poses) == 3
    assert sorted(got) == sorted(want)
    for key in want:
        if key != "poses":
            assert got[key] == want[key], key
    assert np.asarray(got["poses"]).shape == np.asarray(want["poses"]).shape
    np.testing.assert_allclose(run.poses[:, 0, :3], jrun.poses[:, 0, :3],
                               atol=0.01)


# ----------------------------------------------------------------- the CLI

def test_track_service_from_the_command_line(tmp_path, sock_dir, capsys):
    obj = tmp_path / "box.obj"
    m = mesh.box_mesh(0.08, 0.06, 0.05, center=False)
    obj.write_text(
        "".join(f"v {x} {y} {z}\n"
                for x, y, z in m.vertices[:m.num_vertices].tolist())
        + "".join(f"f {a + 1} {b + 1} {c + 1}\n"
                  for a, b, c in m.faces[:m.num_triangles].tolist()))
    conf = tmp_path / "tracker.json"
    conf.write_text(
        '{"tracker": "particle", "object": {"meshes": ["%s"]},'
        ' "camera": {"camera_matrix": [48.0, 0, 16, 0, 48.0, 16, 0, 0, 1],'
        ' "resolution": [32, 32], "downsampling_factor": 1},'
        ' "observation": {"model_sigma": 0.005, "sigma_factor": 0.0},'
        ' "evaluation_count": 128, "backend": "pallas", "seed": 0}' % obj)
    seq = str(tmp_path / "seq.npz")
    assert cli.main(["record", "--config", str(conf), "--device", "cpu",
                     "--output", seq, "--frames", "400", "--distance",
                     "0.6"]) == 0
    sock = os.path.join(sock_dir, "cli.sock")
    t, res = run_in_thread(lambda: cli.main(
        ["track", "--config", str(conf), "--device", "cpu", "--input", seq,
         "--initial-pose", " ".join(map(str, START)), "--service", sock]))
    deadline = time.time() + TIMEOUT
    st = {}
    while time.time() < deadline:
        if os.path.exists(sock):
            st = call(sock, {"cmd": "status"}, timeout=5.0)
            if st.get("frame") is not None:
                break
        time.sleep(0.02)
    assert st.get("ok") and st["frame"] is not None
    assert call(sock, {"cmd": "shutdown"}, timeout=5.0)["ok"]
    assert joined(t, res) == 0
    summary = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("track: ")]
    assert summary and '"frames"' in summary[0]
    frames = int(summary[0].split('"frames": ')[1].split(",")[0])
    assert frames < 400                      # shut down, not run out
    assert not os.path.exists(sock)          # closed in finally


# ------------------------------------------------------ the frame-gap rule

class StubTracker:
    """Records the ``dt`` of every ``track`` call; ``initialize`` replaces
    the belief, as both trackers do. Damping 4/s: a damping time of
    0.25 s."""

    _dt = 1.0 / 30.0
    trans_params = types.SimpleNamespace(damping=torch.tensor(4.0))

    def __init__(self, as_tensor):
        self.belief = object()
        self.calls = []
        self.as_tensor = as_tensor

    def initialize(self, pose, **kwargs):
        self.belief = object()

    def track(self, depth, dt=None):
        self.calls.append(dt)
        pose = np.array([0, 0, 0.6, 1, 0, 0, 0], np.float32)
        return (torch.as_tensor(pose) if self.as_tensor else pose), None


# frames dropped before each frame: 6 intervals (0.2 s, under the damping
# time), 151 (5 s) twice, 10 (0.33 s), 5
GAP_SKIPPED = [None, 0, 5, 150, 150, 9, 4]


def skipped_stream(frame_cls):
    return [frame_cls(i, np.zeros(4, np.float32), None, skipped=s)
            for i, s in enumerate(GAP_SKIPPED)]


class TripOnFrame:
    """A watchdog that trips once, after the step of the ``trip``-th
    frame tracked (0-based)."""

    def __init__(self, trip):
        self.n, self.trip = 0, trip

    def update(self, info, num_particles):
        self.n += 1
        return self.n == self.trip + 1


# the tracked frames' dt by cause (None = the nominal interval), and the
# re-anchored frames: a gap up to the damping time keeps the reference's
# interval; a longer one re-anchors the frame and tracks it at the
# nominal interval, unless the frame before was re-anchored (then the
# interval is capped at the damping time); a frame a command
# re-initialized the tracker on is tracked at the nominal interval
B = StubTracker._dt
GAP_RULE = {
    # a pause or a stall
    "gap": ([None, None, 6 * B, None, 0.25, None, 5 * B], [3, 5]),
    # reset_pose applied before frame 3
    "command": ([None, None, 6 * B, None, None, 0.25, 5 * B], [4]),
    # the watchdog's search on frame 2
    "watchdog": ([None, None, 6 * B, None, 0.25, None, 5 * B], [3, 5]),
    # the watchdog's search on frame 3, a re-anchored one: the search
    # placed the belief anew, so frame 4 after its gap is re-anchored
    "watchdog_on_reanchor": ([None, None, 6 * B, None, None, 0.25, 5 * B],
                             [3, 4]),
}
# the frame after whose step the watchdog trips, by cause
TRIP = {"watchdog": 2, "watchdog_on_reanchor": 3}


@pytest.mark.parametrize("cause", sorted(GAP_RULE))
def test_frame_gap_rule(cause, monkeypatch):
    """The port's rule for a frame after dropped frames, whatever dropped
    them; the reference propagates every frame over its whole gap, which
    loses the belief after a 5 s search (PERF.md)."""
    from dbot_ros_tpu_torch.runtime import initializer

    anchored = []

    def reanchor(tr, depth, **kw):
        anchored.append(len(tr.calls))      # frames tracked before it
        tr.initialize(START)
        return torch.as_tensor(START)[None], torch.as_tensor(START)[None]

    monkeypatch.setattr(initializer, "reanchor_tracker", reanchor)
    monkeypatch.setattr(initializer, "initialize_tracker",
                        lambda tr, depth, **kw: tr.initialize(START))
    tracker = StubTracker(True)
    svc = TrackerService()

    def on_frame(frame, poses, info):
        if cause == "command" and frame.index == 2:
            svc.submit({"cmd": "reset_pose", "pose": START.tolist()})

    run = node.run(tracker, skipped_stream(sources.Frame),
                   initial_pose=START, on_frame=on_frame, service=svc,
                   watchdog=TripOnFrame(TRIP[cause]) if cause in TRIP
                   else None)
    want_dt, want_frames = GAP_RULE[cause]
    assert [c is None for c in tracker.calls] == \
        [w is None for w in want_dt]
    np.testing.assert_allclose([c for c in tracker.calls if c is not None],
                               [w for w in want_dt if w is not None])
    assert [r.frame for r in run.reanchors] == want_frames == anchored
    assert [r.skipped for r in run.reanchors] == \
        [GAP_SKIPPED[f] for f in want_frames]
    assert run.reinit_frames == ([TRIP[cause]] if cause in TRIP else [])
    if cause == "command":
        # the reference, on the same frames: the whole gap every time
        jtracker = StubTracker(False)
        jsvc = jservice.TrackerService()

        def jon_frame(frame, poses, info):
            if frame.index == 2:
                jsvc.submit({"cmd": "reset_pose", "pose": START.tolist()})

        jnode.run(jtracker, skipped_stream(jsources.Frame),
                  initial_pose=START, on_frame=jon_frame, service=jsvc)
        assert jtracker.calls == [None, None, 6 * B, 151 * B, 151 * B,
                                  10 * B, 5 * B]


def test_a_failed_reanchor_keeps_the_capped_propagation(monkeypatch, capsys):
    """A re-anchor that raises does not end the run: the frame is
    propagated over the damping time, counted and reported on stderr,
    and the next long gap is tried again."""
    from dbot_ros_tpu_torch.runtime import initializer

    def reanchor(tr, depth, **kw):
        raise RuntimeError("no luck")

    monkeypatch.setattr(initializer, "reanchor_tracker", reanchor)
    tracker = StubTracker(True)
    run = node.run(tracker, skipped_stream(sources.Frame),
                   initial_pose=START)
    np.testing.assert_allclose(
        [c for c in tracker.calls if c is not None],
        [6 * B, 0.25, 0.25, 0.25, 5 * B])
    assert tracker.calls[:2] == [None, None]
    assert run.reanchors == [] and run.unanchored_frames == [3, 4, 5]
    err = capsys.readouterr().err
    assert err.count("re-anchor failed: RuntimeError: no luck") == 3
