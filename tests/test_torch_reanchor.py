"""The port's gap rule in ``node.run``: a frame that arrives after a gap
longer than the transition's damping time re-anchors the belief on that
frame (``initializer.reanchor_tracker``: the search's deterministic
alignment and polish, seeded from what the tracker holds) before it is
tracked at the nominal interval.

The reference has no re-anchor: it propagates such a frame over the
whole gap (``dbot_ros_tpu/runtime/node.py``, held by
``test_frame_gap_rule`` in ``tests/test_torch_service.py``). Each case
here shows the fault beside the repair: the same frames tracked with the
capped propagation (over the damping time, the port's rule before the
re-anchor) land further off.

Scene: a 40×30 camera (fx 60), a 320-face icosphere 0.6 m away over a
background at 2 m (``SyntheticSource``); between frame A and frame B
the source dropped 150 frames (5 s at 30 Hz) and the object moved 11.9
mm and 0.05 rad. Bounds, for both trackers: the re-anchored pose as
placed and the pose tracked on B within 3 mm and nearer than the capped
propagation's.
"""

import numpy as np
import pytest
import torch

from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch.runtime import initializer, node, sources
from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
from dbot_ros_tpu_torch.utils import camera, mesh, se3

torch.set_num_threads(1)

K40 = np.array([[60.0, 0, 20], [0, 60.0, 15], [0, 0, 1.0]])
H, W = 30, 40
TRANSITION = cfg.TransitionConfig(0.1, 0.5, damping=4.0)   # 0.25 s
P0 = np.array([0.0, 0.0, 0.6, 1, 0, 0, 0], np.float32)
MOVE = np.array([0.009, -0.006, 0.005], np.float32)          # 11.9 mm
TURN = np.array([0.0, 0.05, 0.0], np.float32)                # rad
EMPTY = np.full((H, W), 2.0, np.float32)    # the scene without objects
SKIPPED = 150


def moved(pose, move=MOVE, turn=TURN):
    q = se3.quat_boxplus(torch.tensor(pose[3:7]), torch.tensor(turn))
    return np.concatenate([pose[:3] + move, q.numpy()]).astype(np.float32)


def gap_frames(meshes, before, after, seed=0):
    """Frames A (poses ``before`` (K, 7)) and B (``after``), B reporting
    ``SKIPPED`` dropped frames as a push source would."""
    cam = camera.make_camera(K40, H, W)
    a, b = sources.SyntheticSource(
        meshes, cam, lambda t: before if t == 0 else after, 2,
        noise_sigma=0.002, seed=seed)
    return cam, [a, sources.Frame(1 + SKIPPED, b.depth, b.ground_truth,
                                  skipped=SKIPPED)]


def make(kind, meshes, cam, start):
    """A tracker on the CPU initialized at ``start`` (a Gaussian one over
    a background map of the empty scene)."""
    if kind == "particle":
        tracker = ParticleTracker(cfg.ParticleTrackerConfig(
            evaluation_count=512, backend="pallas", transition=TRANSITION),
            meshes=meshes, camera=cam, device="cpu")
        tracker.initialize(start)
    else:
        tracker = GaussianTracker(cfg.GaussianTrackerConfig(
            transition=TRANSITION), meshes=meshes, camera=cam,
            device="cpu")
        tracker.initialize(start, first_frame=EMPTY)
    return tracker


def mm(poses, truth):
    """Per-object position errors in mm of (K, 7) against (K, 7)."""
    poses = np.asarray(poses, np.float32).reshape(-1, 7)
    return 1e3 * np.linalg.norm(poses[:, :3] - truth.reshape(-1, 7)[:, :3],
                                axis=-1)


def capped(kind, meshes, cam, start, frames):
    """The same frames with B propagated over the damping time."""
    tracker = make(kind, meshes, cam, start)
    tracker.track(frames[0].depth)
    poses, _ = tracker.track(frames[1].depth, dt=0.25)
    return poses.numpy()


@pytest.mark.parametrize("kind", ["particle", "gaussian"])
def test_long_gap_is_reanchored_on_the_newest_frame(kind):
    sphere = mesh.icosphere_mesh(radius=0.06, subdivisions=2)
    p1 = moved(P0)
    cam, frames = gap_frames([sphere], P0[None], p1[None])
    run = node.run(make(kind, [sphere], cam, P0), frames)
    assert [r.frame for r in run.reanchors] == [frames[1].index]
    r = run.reanchors[0]
    assert r.skipped == SKIPPED and r.seconds > 0
    assert run.unanchored_frames == []
    assert mm(r.before, p1)[0] > 10.0               # the stale mean
    placed, tracked = mm(r.after, p1)[0], mm(run.poses[1], p1)[0]
    worse = mm(capped(kind, [sphere], cam, P0, frames), p1)[0]
    assert placed < 3.0 and placed < worse
    assert tracked < 3.0 and tracked < worse


def test_gaussian_reanchor_keeps_the_covariance():
    """A Gaussian belief is re-anchored with the covariance it had (the
    initial spread over a learned background map throws the first step
    several mm off), its velocity reset and its background map kept."""
    sphere = mesh.icosphere_mesh(radius=0.06, subdivisions=2)
    cam, frames = gap_frames([sphere], P0[None], moved(P0)[None])
    tracker = make("gaussian", [sphere], cam, P0)
    for _ in range(3):
        tracker.track(frames[0].depth)
    old = tracker.belief
    initializer.reanchor_tracker(tracker, frames[1].depth)
    new = tracker.belief
    assert new is not old
    assert torch.equal(new.cov, old.cov)
    assert torch.equal(new.background, old.background)
    assert torch.all(new.mean[..., 7:] == 0)
    assert not torch.equal(new.mean[..., :3], old.mean[..., :3])


def test_two_objects_are_reanchored_one_by_one():
    """K = 2 (a sphere and a box side by side): each object is aligned on
    its own cluster of the foreground with the other's render as the
    scene depth."""
    meshes = [mesh.icosphere_mesh(radius=0.05, subdivisions=2),
              mesh.box_mesh(0.06, 0.08, 0.05)]
    start = np.stack([[-0.08, 0.0, 0.6, 1, 0, 0, 0],
                      [0.08, 0.01, 0.62, 1, 0, 0, 0]]).astype(np.float32)
    end = np.stack([moved(start[0]), moved(start[1], -MOVE, -TURN)])
    cam, frames = gap_frames(meshes, start, end)
    run = node.run(make("particle", meshes, cam, start), frames)
    assert len(run.reanchors) == 1
    assert np.all(mm(run.reanchors[0].before, end) > 10.0)
    assert np.all(mm(run.reanchors[0].after, end) < 3.0)
    assert np.all(mm(run.poses[1], end) < 3.0)
    assert np.all(mm(capped("particle", meshes, cam, start, frames), end)
                  > mm(run.poses[1], end))


def test_reanchor_takes_no_draws():
    """No draws: the tracker's generator (as ``initialize`` re-seeds it)
    and the global stream are as they were, and a second tracker in the
    same state is placed at the same bits."""
    sphere = mesh.icosphere_mesh(radius=0.06, subdivisions=2)
    cam, frames = gap_frames([sphere], P0[None], moved(P0)[None])
    placed = []
    for _ in range(2):
        tracker = make("particle", [sphere], cam, P0)
        gen, glob = tracker.generator.get_state(), torch.get_rng_state()
        placed.append(initializer.reanchor_tracker(tracker,
                                                   frames[1].depth)[1])
        assert torch.equal(tracker.generator.get_state(), gen)
        assert torch.equal(torch.get_rng_state(), glob)
    assert torch.equal(placed[0], placed[1])


def test_reanchor_restarts_an_island_trial_from_each_hypothesis():
    """In a trial every racing hypothesis is re-anchored; the trial
    restarts with all of them, re-scored on the newest frame."""
    sphere = mesh.icosphere_mesh(radius=0.06, subdivisions=2)
    p1 = moved(P0)
    cam, frames = gap_frames([sphere], P0[None], p1[None])
    tracker = make("particle", [sphere], cam, P0)
    off = P0.copy()
    off[:3] += [0.02, 0.0, 0.01]
    tracker.initialize(P0, hypotheses=np.stack([P0, off]),
                       hypothesis_logits=np.array([0.0, -1.0]))
    tracker.track(frames[0].depth)
    assert tracker.trial_active == 2
    initializer.reanchor_tracker(tracker, frames[1].depth)
    assert tracker.trial_active == 2
    assert tracker._trial["left"] == 8 and tracker._trial["elapsed"] == 0
    means = tracker.hypothesis_means()
    assert means.shape == (2, 1, 7)
    assert np.all(mm(means.reshape(2, 7).numpy(), np.stack([p1, p1]))
                  < 3.0)


def test_frame_without_foreground_keeps_the_capped_propagation(capsys):
    """A long gap onto a frame with no pixel in the search's depth band
    cannot be aligned: the frame is propagated over the damping time,
    counted and reported on stderr."""
    sphere = mesh.icosphere_mesh(radius=0.06, subdivisions=2)
    cam, frames = gap_frames([sphere], P0[None], moved(P0)[None])
    frames[1].depth = EMPTY.copy()
    tracker = make("particle", [sphere], cam, P0)
    dts = []
    track = tracker.track

    def counted(depth, dt=None):
        dts.append(dt)
        return track(depth, dt=dt)

    tracker.track = counted
    run = node.run(tracker, frames)
    assert run.reanchors == [] and run.unanchored_frames == [frames[1].index]
    assert dts == [None, 0.25]
    assert "no foreground to re-anchor on" in capsys.readouterr().err


@pytest.mark.parametrize("shape", ["sphere", "l_shape", "box"])
def test_clipped_render_is_the_full_render(shape):
    """The re-anchor raycasts only the pixels whose rays meet a pose's
    bounding sphere: every other pixel misses, so the depths are the
    full render's (float rounding of the 3-term ray products aside), for
    poses in view, at the frame's edge and half out of it."""
    m = {"sphere": mesh.icosphere_mesh(radius=0.06, subdivisions=2),
         "l_shape": mesh.l_shape_mesh(center=False),
         "box": mesh.box_mesh(0.05, 0.08, 0.03)}[shape]
    cam = camera.make_camera(K40, H, W)
    g = np.random.default_rng(3)
    poses = np.zeros((12, 7), np.float32)
    poses[:, :3] = [0.0, 0.0, 0.6] + g.uniform(-0.25, 0.25, (12, 3)) \
        * [1.0, 1.0, 0.4]
    poses[:, 3:] = g.standard_normal((12, 4))
    poses[:, 3:] /= np.linalg.norm(poses[:, 3:], axis=1, keepdims=True)
    poses = torch.as_tensor(poses)
    full = initializer._render(m, cam, poses)
    clipped = initializer._render(m, cam, poses, clip=True)
    assert torch.equal(torch.isfinite(full), torch.isfinite(clipped))
    assert int(torch.isfinite(full).sum()) > 50
    torch.testing.assert_close(clipped, full, rtol=0, atol=1e-6)
