"""Streaming tracker loop.

Port of ``run`` and ``TrackRun`` from ``dbot_ros_tpu/runtime/node.py``:
wire a frame source to a tracker, collect per-frame metrics and the
estimated trajectory, and (with ground truth) report pose RMSE. Not
ported yet: checkpointing, the watchdog and the control service
(passing any of them raises NotImplementedError).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from dbot_ros_tpu.runtime.metrics import FrameMetrics, MetricsLog
from dbot_ros_tpu_torch.utils import se3


@dataclasses.dataclass
class TrackRun:
    """Result of a streaming run."""

    poses: np.ndarray            # (T, K, 7) estimated model-frame poses
    metrics: MetricsLog
    ground_truth: Optional[np.ndarray] = None   # (T, K, 7) if source had it
    reinit_frames: List[int] = dataclasses.field(default_factory=list)

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
      tracker: a ParticleTracker (initialize/track API).
      source: iterable of runtime.sources.Frame.
      initial_pose: model-frame pose(s); defaults to the source's first
        ground truth.
      on_frame: optional callback(frame, poses, info).
      checkpoint_path, watchdog, service: not ported yet.
    """
    if checkpoint_path or watchdog is not None or service is not None:
        raise NotImplementedError(
            "checkpoint, watchdog and service are not ported yet "
            "(ROADMAP queue A, 'Checkpoint, watchdog and service')")
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
        tracker.initialize(initial_pose)

    poses_out: List[np.ndarray] = []
    gt_out: List[np.ndarray] = []
    log = MetricsLog()
    # frames dropped by a push source propagate over the real interval
    base_dt = getattr(tracker, "_dt", None)

    def handle(frame):
        t0 = time.perf_counter()
        trial_n = getattr(tracker, "trial_active", None)
        skipped = getattr(frame, "skipped", None)
        if base_dt is not None and skipped:
            poses, info = tracker.track(frame.depth,
                                        dt=base_dt * (1 + skipped))
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

    handle(first)
    for frame in frames:
        handle(frame)

    num_objects = len(getattr(tracker, "meshes", [None]))
    return TrackRun(
        poses=(np.stack(poses_out) if poses_out
               else np.zeros((0, num_objects, 7))),
        metrics=log,
        ground_truth=np.stack(gt_out) if gt_out and
        len(gt_out) == len(poses_out) else None)
