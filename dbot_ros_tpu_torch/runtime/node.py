"""Streaming tracker loop.

Port of ``run`` and ``TrackRun`` from ``dbot_ros_tpu/runtime/node.py``:
wire a frame source to a tracker, collect per-frame metrics and the
estimated trajectory, checkpoint the belief, re-acquire through the
watchdog, take commands from the control service, and (with ground
truth) report pose RMSE.
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


@dataclasses.dataclass
class TrackRun:
    """Result of a streaming run."""

    poses: np.ndarray            # (T, K, 7) estimated model-frame poses
    metrics: MetricsLog
    ground_truth: Optional[np.ndarray] = None   # (T, K, 7) if source had it
    reinit_frames: List[int] = dataclasses.field(default_factory=list)
    # seconds each watchdog re-init (the 6-DoF search) took
    reinit_seconds: List[float] = dataclasses.field(default_factory=list)

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
        ``skipped`` dropped frames is propagated over ``1 + skipped``
        frame intervals, but the first frame after a re-initialization
        over at most the transition's damping time (see below).
      checkpoint_path, checkpoint_every: save the belief (and a particle
        tracker's generator state) every ``checkpoint_every`` frames.
      watchdog: optional runtime.watchdog.TrackingWatchdog, fed every
        frame's step info. When it trips, the tracker is re-initialized
        from the *current* frame by the 6-DoF search
        (runtime.initializer.initialize_tracker) racing at least two
        hypotheses. Tripped frame indices land in
        ``TrackRun.reinit_frames``.
      reinit_kwargs: forwarded to that search (n_axes, n_spins,
        refine_particles, depth range: speed against robustness).
      service: optional runtime.service.TrackerService: its queued
        commands (reset_pose, find_object, checkpoint, shutdown) are
        applied on this thread before each frame, a pause holds the loop
        without pulling frames, and the status is updated after each
        frame. Its ``find_object`` frames join ``reinit_frames``.
    """
    frames = iter(source)
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
    log = MetricsLog()
    num_particles = getattr(getattr(tracker, "config", None),
                            "evaluation_count", None)
    # frames dropped by a push source propagate over the real interval
    base_dt = getattr(tracker, "_dt", None)
    # A re-initialization (a service command applied before a frame, or
    # the watchdog's search after one) places the belief at that frame,
    # and a push source drops the frames that arrive while it runs (~150
    # in a 5 s search at 30 Hz). The reference propagates the next frame
    # over all of them: its integrated-Wiener noise grows as dt^3 (sigma
    # 0.65 m per axis after 5 s at 0.1 m/s^1.5) and loses a 10k-particle
    # belief. The port propagates it over the real interval up to the
    # transition's damping time 1/damping (0.25 s by default), the
    # longest over which that noise still models the damped motion.
    damping = getattr(getattr(tracker, "trans_params", None), "damping",
                      None)
    reinit_max_dt = (1.0 / float(damping)
                     if damping is not None and float(damping) > 0
                     else base_dt)
    reanchored = False

    def pump_service(frame):
        """Apply queued commands; hold here while paused (no frame is
        pulled, so a paused replay resumes where it stopped). False =
        shutdown."""
        if service is None:
            return True
        while True:
            if service.apply_pending(tracker, frame, reinit_kwargs):
                return False
            if not service.paused:
                return True
            time.sleep(0.01)

    def handle(frame):
        nonlocal reanchored
        belief = getattr(tracker, "belief", None)
        if not pump_service(frame):
            return False                          # shutdown requested
        # a command re-initialized the tracker on this frame
        commanded = getattr(tracker, "belief", None) is not belief
        t0 = time.perf_counter()
        trial_n = getattr(tracker, "trial_active", None)
        skipped = getattr(frame, "skipped", None)
        # a commanded re-initialization placed the belief at this frame
        if base_dt is not None and skipped and not commanded:
            dt = base_dt * (1 + skipped)
            if reanchored:
                dt = max(base_dt, min(dt, reinit_max_dt))
            poses, info = tracker.track(frame.depth, dt=dt)
        else:
            poses, info = tracker.track(frame.depth)
        poses = poses.detach().cpu().numpy()     # waits for the device
        if poses.ndim == 1:
            poses = poses[None]
        latency = time.perf_counter() - t0
        poses_out.append(poses)
        if frame.ground_truth is not None:
            gt = np.asarray(frame.ground_truth)
            gt_out.append(gt if gt.ndim == 2 else gt[None])
        m = FrameMetrics.from_info(frame.index, info, latency)
        m.skipped = skipped
        m.trial_hypotheses = trial_n
        log.append(m)
        if on_frame is not None:
            on_frame(frame, poses, info)
        reanchored = commanded
        if watchdog is not None and watchdog.update(info, num_particles):
            # tracking lost: global re-acquisition on the current frame.
            # Contained: a degenerate frame (an all-NaN burst, exactly the
            # frames that trip the dog) must not kill the run; the
            # watchdog re-arms and retries on a later frame.
            from dbot_ros_tpu_torch.runtime.initializer import \
                initialize_tracker
            t_search = time.perf_counter()
            try:
                # flip-aware recovery: a re-init after a lock-in races at
                # least 2 beam hypotheses, because the wrong basin can
                # win the single-frame search argmax
                initialize_tracker(tracker, frame.depth,
                                   **{"min_hypotheses": 2,
                                      "reuse_background": True,
                                      **(reinit_kwargs or {})})
                reinit_frames.append(frame.index)
                reinit_seconds.append(time.perf_counter() - t_search)
                reanchored = True
            except Exception as e:  # noqa: BLE001 - keep tracking
                print(f"watchdog re-init failed on frame {frame.index}: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
        if checkpoint_path and checkpoint_every \
                and (frame.index + 1) % checkpoint_every == 0:
            from dbot_ros_tpu_torch.runtime.checkpoint import save_belief
            save_belief(checkpoint_path, tracker.belief,
                        generator=getattr(tracker, "generator", None))
        if service is not None:
            service.update_status(frame.index, poses)
        return True

    if handle(first):
        for frame in frames:
            if not handle(frame):
                break

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
        reinit_frames=reinit_frames, reinit_seconds=reinit_seconds)
