"""Streaming tracker loop.

Port of ``run`` and ``TrackRun`` from ``dbot_ros_tpu/runtime/node.py``:
wire a frame source to a tracker, collect per-frame metrics and the
estimated trajectory, checkpoint the belief, re-acquire through the
watchdog, take commands from the control service, and (with ground
truth) report pose RMSE.

**Frame gaps.** A push source drops frames while the loop is busy (a
search, a pause, a stall) and reports them as ``Frame.skipped``. With
``gap = (1 + skipped) / frame_rate`` and the transition's damping time
``1 / damping`` (0.25 s by default), the longest interval over which its
integrated-Wiener noise still models the damped motion:

1. ``gap`` up to the damping time: the frame propagates over ``gap``,
   the reference's rule.
2. a longer ``gap``: the belief is re-anchored on this frame (the
   search's deterministic alignment and polish, seeded from the poses
   the tracker holds: ``initializer.reanchor_tracker``), and the frame
   is tracked at the nominal interval. The reference propagates over the
   whole gap, whose noise (0.65 m per axis after 5 s at 0.1 m/s^1.5)
   loses the belief.
3. the frame right after a re-anchor propagates over its gap capped at
   the damping time, so that re-anchors do not chain (a watchdog search
   on that frame lifts the cap: the search placed the belief anew); so
   does a frame with no foreground pixel in the search's depth band,
   which cannot be aligned, or whose re-anchor raised (counted in
   ``TrackRun.unanchored_frames``, a line on stderr).

A frame on which a command re-initialized the tracker is tracked at the
nominal interval.
"""

from __future__ import annotations

import dataclasses
import inspect
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from dbot_ros_tpu_torch.runtime.metrics import FrameMetrics, MetricsLog
from dbot_ros_tpu_torch.utils import se3
from dbot_ros_tpu_torch.utils.profiling import span


_END = object()      # the source is exhausted


@dataclasses.dataclass
class Reanchor:
    """One re-anchor after a long frame gap."""

    frame: int
    skipped: int                 # frames the source dropped before it
    seconds: float
    before: np.ndarray           # (K, 7) published model-frame poses
    after: np.ndarray            # (K, 7) as placed on this frame


@dataclasses.dataclass
class TrackRun:
    """Result of a streaming run."""

    poses: np.ndarray            # (T, K, 7) estimated model-frame poses
    metrics: MetricsLog
    ground_truth: Optional[np.ndarray] = None   # (T, K, 7) if source had it
    reinit_frames: List[int] = dataclasses.field(default_factory=list)
    # seconds each watchdog re-init (the 6-DoF search) took
    reinit_seconds: List[float] = dataclasses.field(default_factory=list)
    reanchors: List[Reanchor] = dataclasses.field(default_factory=list)
    # frames after a long gap that could not be re-anchored on
    unanchored_frames: List[int] = dataclasses.field(default_factory=list)

    def position_errors(self):
        if self.ground_truth is None:
            return None
        return np.linalg.norm(self.poses[..., :3]
                              - self.ground_truth[..., :3], axis=-1)

    def rotation_errors(self, symmetries=None):
        """Per-frame per-object rotation errors (T, K); ``symmetries`` is
        an optional per-object list of (S, 4) quaternion groups (None =
        exact metric)."""
        if self.ground_truth is None:
            return None
        qe = torch.as_tensor(self.poses[..., 3:7], dtype=torch.float32)
        qg = torch.as_tensor(self.ground_truth[..., 3:7],
                             dtype=torch.float32)
        if symmetries is None:
            return torch.linalg.norm(se3.quat_boxminus(qe, qg),
                                     dim=-1).numpy()
        cols = []
        for k in range(qe.shape[1]):
            if symmetries[k] is None:
                dq = se3.quat_boxminus(qe[:, k], qg[:, k])
                cols.append(torch.linalg.norm(dq, dim=-1).numpy())
            else:
                cols.append(se3.rotation_error_symmetric(
                    qe[:, k], qg[:, k], symmetries[k]).numpy())
        return np.stack(cols, axis=1)

    def position_rmse(self):
        e = self.position_errors()
        return None if e is None else float(np.sqrt(np.mean(e ** 2)))

    def rotation_rmse(self, symmetries=None):
        e = self.rotation_errors(symmetries)
        return None if e is None else float(np.sqrt(np.mean(e ** 2)))


def run(tracker, source, initial_pose=None,
        on_frame: Optional[Callable] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        watchdog=None, reinit_kwargs: Optional[dict] = None,
        service=None) -> TrackRun:
    """Stream a source through a tracker.

    Args:
      tracker: a ParticleTracker or a GaussianTracker (initialize/track
        API; the Gaussian tracker's background map is seeded from the
        first frame).
      source: iterable of runtime.sources.Frame.
      initial_pose: model-frame pose(s); defaults to the source's first
        ground truth.
      on_frame: optional callback(frame, poses, info), the publisher
        hook; ``poses`` is a (K, 7) numpy array. A frame that reports
        ``skipped`` dropped frames follows the gap rule of the module
        docstring; its re-anchors land in ``TrackRun.reanchors``.
      checkpoint_path, checkpoint_every: save the belief (and a particle
        tracker's generator state) every ``checkpoint_every`` frames.
      watchdog: optional runtime.watchdog.TrackingWatchdog, fed every
        frame's step info. When it trips, the tracker is re-initialized
        from the *current* frame by the 6-DoF search
        (runtime.initializer.initialize_tracker) racing at least two
        hypotheses. Tripped frame indices land in
        ``TrackRun.reinit_frames``.
      reinit_kwargs: forwarded to that search (n_axes, n_spins,
        refine_particles, depth range: speed against robustness); a
        re-anchor takes its depth range and ``polish_rounds``.
      service: optional runtime.service.TrackerService: its queued
        commands (reset_pose, find_object, checkpoint, shutdown) are
        applied on this thread before each frame, a pause holds the loop
        without pulling frames, and the status is updated after each
        frame. Its ``find_object`` frames join ``reinit_frames``.
    """
    frames = iter(source)
    with span("dbot.loop.source"):
        first = next(frames)

    already_initialized = (initial_pose is None
                           and getattr(tracker, "belief", None) is not None)
    if not already_initialized:
        if initial_pose is None:
            if first.ground_truth is None:
                raise ValueError(
                    "no initial pose, tracker not initialized, and source "
                    "has no ground truth")
            initial_pose = first.ground_truth
        if "first_frame" in inspect.signature(
                tracker.initialize).parameters:
            tracker.initialize(initial_pose, first_frame=first.depth)
        else:
            tracker.initialize(initial_pose)

    poses_out: List[np.ndarray] = []
    gt_out: List[np.ndarray] = []
    reinit_frames: List[int] = []
    reinit_seconds: List[float] = []
    reanchors: List[Reanchor] = []
    unanchored: List[int] = []
    log = MetricsLog()
    num_particles = getattr(getattr(tracker, "config", None),
                            "evaluation_count", None)
    # frames dropped by a push source propagate over the real interval
    base_dt = getattr(tracker, "_dt", None)
    # the gap rule's threshold: the transition's damping time
    damping = getattr(getattr(tracker, "trans_params", None), "damping",
                      None)
    reinit_max_dt = (1.0 / float(damping)
                     if damping is not None and float(damping) > 0
                     else base_dt)
    after_reanchor = False

    def pump_service(frame):
        """Apply queued commands; hold here while paused (no frame is
        pulled, so a paused replay resumes where it stopped). False =
        shutdown."""
        while True:
            if service.apply_pending(tracker, frame, reinit_kwargs):
                return False
            if not service.paused:
                return True
            time.sleep(0.01)

    def reanchor(frame):
        """Rule 2 on ``frame``: True when the belief was placed on it."""
        from dbot_ros_tpu_torch.runtime.initializer import reanchor_tracker
        t_start = time.perf_counter()
        try:
            with span("dbot.loop.reanchor"):
                placed = reanchor_tracker(tracker, frame.depth,
                                          **(reinit_kwargs or {}))
            why = "no foreground to re-anchor on"
        except Exception as e:  # noqa: BLE001 - keep tracking
            placed, why = None, (f"re-anchor failed: {type(e).__name__}: "
                                 f"{e}")
        if placed is None:
            unanchored.append(frame.index)
            print(f"frame {frame.index}: {why} after {frame.skipped} "
                  f"dropped frames; propagated over "
                  f"{max(base_dt, reinit_max_dt):.3f} s", file=sys.stderr)
            return False
        before, after = (p.detach().cpu().numpy().reshape(-1, 7)
                         for p in placed)
        reanchors.append(Reanchor(frame.index, int(frame.skipped),
                                  time.perf_counter() - t_start,
                                  before, after))
        return True

    def watch(frame, info):
        """Feed the watchdog the frame's step info; when it trips
        (tracking lost), re-acquire globally on the current frame.
        Contained: a degenerate frame (an all-NaN burst, exactly the
        frames that trip the dog) must not kill the run; the watchdog
        re-arms and retries on a later frame."""
        nonlocal after_reanchor
        if not watchdog.update(info, num_particles):
            return
        from dbot_ros_tpu_torch.runtime.initializer import initialize_tracker
        t_search = time.perf_counter()
        try:
            # flip-aware recovery: a re-init after a lock-in races at
            # least 2 beam hypotheses, because the wrong basin can win
            # the single-frame search argmax
            initialize_tracker(tracker, frame.depth,
                               **{"min_hypotheses": 2,
                                  "reuse_background": True,
                                  **(reinit_kwargs or {})})
            reinit_frames.append(frame.index)
            reinit_seconds.append(time.perf_counter() - t_search)
            # the belief is placed on this frame: the next one after the
            # search's gap is re-anchored
            after_reanchor = False
        except Exception as e:  # noqa: BLE001 - keep tracking
            print(f"watchdog re-init failed on frame {frame.index}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)

    def handle(frame):
        nonlocal after_reanchor
        belief = getattr(tracker, "belief", None)
        if service is not None:
            with span("dbot.loop.service"):
                if not pump_service(frame):
                    return False                  # shutdown requested
        # a command re-initialized the tracker on this frame
        commanded = getattr(tracker, "belief", None) is not belief
        skipped = getattr(frame, "skipped", None)
        dt = None                                 # the nominal interval
        anchored = False
        if base_dt is not None and skipped and not commanded:
            gap = base_dt * (1 + skipped)
            if gap <= reinit_max_dt:
                dt = gap
            elif not after_reanchor and reanchor(frame):
                anchored = True
            else:
                dt = max(base_dt, reinit_max_dt)
        trial_n = getattr(tracker, "trial_active", None)
        t0 = time.perf_counter()
        with span("dbot.track"):
            if dt is None:
                poses, info = tracker.track(frame.depth)
            else:
                poses, info = tracker.track(frame.depth, dt=dt)
        with span("dbot.read.pose"):
            poses = poses.detach().cpu().numpy()  # waits for the device
        if poses.ndim == 1:
            poses = poses[None]
        latency = time.perf_counter() - t0
        poses_out.append(poses)
        if frame.ground_truth is not None:
            gt = np.asarray(frame.ground_truth)
            gt_out.append(gt if gt.ndim == 2 else gt[None])
        with span("dbot.read.metrics"):
            m = FrameMetrics.from_info(frame.index, info, latency)
        m.skipped = skipped
        m.trial_hypotheses = trial_n
        log.append(m)
        if on_frame is not None:
            with span("dbot.loop.on_frame"):
                on_frame(frame, poses, info)
        after_reanchor = anchored
        if watchdog is not None:
            with span("dbot.loop.watchdog"):
                watch(frame, info)
        if checkpoint_path and checkpoint_every \
                and (frame.index + 1) % checkpoint_every == 0:
            from dbot_ros_tpu_torch.runtime.checkpoint import save_belief
            with span("dbot.loop.checkpoint"):
                save_belief(checkpoint_path, tracker.belief,
                            generator=getattr(tracker, "generator", None))
        if service is not None:
            with span("dbot.loop.service"):
                service.update_status(frame.index, poses)
        return True

    frame = first
    while frame is not _END:
        with span("dbot.loop.frame"):
            if not handle(frame):
                break
        with span("dbot.loop.source"):
            frame = next(frames, _END)

    if service is not None:
        reinit_frames = reinit_frames + list(service.reinit_frames)
        reinit_seconds = reinit_seconds + list(service.reinit_seconds)

    num_objects = len(getattr(tracker, "meshes", [None]))
    return TrackRun(
        poses=(np.stack(poses_out) if poses_out
               else np.zeros((0, num_objects, 7))),
        metrics=log,
        ground_truth=np.stack(gt_out) if gt_out and
        len(gt_out) == len(poses_out) else None,
        reinit_frames=reinit_frames, reinit_seconds=reinit_seconds,
        reanchors=reanchors, unanchored_frames=unanchored)
