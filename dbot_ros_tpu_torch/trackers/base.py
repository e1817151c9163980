"""Tracker utilities: output smoothing + frame conventions.

Port of ``to_center_frame``, ``to_model_frame`` and
``moving_average_pose`` from ``dbot_ros_tpu/trackers/base.py``. Filters
work in the centred-mesh frame (rotation about the centroid); users give
and receive poses in the original mesh frame.
"""

from __future__ import annotations

from dbot_ros_tpu_torch.utils import se3


def to_center_frame(pose_model, center):
    """Model-frame pose → centred-frame pose: x_cam = R x_c + (t + R c)."""
    t = se3.pose_trans(pose_model) + se3.quat_rotate(
        se3.pose_quat(pose_model),
        center.expand(pose_model.shape[:-1] + (3,)))
    return se3.make_pose(t, se3.pose_quat(pose_model))


def to_model_frame(pose_center, center):
    """Centred-frame pose → model-frame pose (inverse of the above)."""
    t = se3.pose_trans(pose_center) - se3.quat_rotate(
        se3.pose_quat(pose_center),
        center.expand(pose_center.shape[:-1] + (3,)))
    return se3.make_pose(t, se3.pose_quat(pose_center))


def moving_average_pose(smoothed, new, rate):
    """EMA on SE(3): position lerp, rotation geodesic step; rate = 1 → no
    smoothing."""
    xi = se3.pose_boxminus(new, smoothed)
    return se3.pose_boxplus(smoothed, float(rate) * xi)
