"""Tracker utilities: output smoothing, frame conventions and the
description of an assembled tracker.

Port of ``dbot_ros_tpu/trackers/base.py``. Filters work in the
centred-mesh frame (rotation about the centroid); users give and receive
poses in the original mesh frame.
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


def describe(tracker) -> str:
    """Human-readable composition of an assembled tracker of either
    kind: what got built from the config (estimator, sensor backend or
    sigma renderer, models, scene, camera, device)."""
    cam = tracker.camera
    mesh_str = ", ".join(
        f"{m.num_triangles} tris (pad {m.padded_triangles})"
        for m in tracker.meshes)
    bp = tracker.beam_params
    c, tr = tracker.config, tracker.config.transition
    lines = [
        f"  camera: {cam.height}x{cam.width} ({cam.num_pixels} px), "
        f"fx={float(cam.camera_matrix[0, 0]):.1f}",
        f"  objects[{len(tracker.meshes)}]: {mesh_str}",
        f"  beam model: sigma={float(bp.model_sigma):g} + "
        f"{float(bp.sigma_factor):g}/m, tail={float(bp.tail_weight):g}, "
        f"depth=[{float(bp.min_depth):g}, {float(bp.max_depth):g}] m",
        f"  transition: damped Wiener, sigma_lin="
        f"{tr.linear_acceleration_sigma:g}, sigma_ang="
        f"{tr.angular_acceleration_sigma:g}, damping={tr.damping:g}",
    ]
    if hasattr(c, "evaluation_count"):
        head = (f"ParticleTracker (RBC-PF): {c.evaluation_count} "
                f"particles, backend={c.backend}, "
                f"max_kl={c.max_kl_divergence:g}, device={tracker.device}")
        op = tracker.occ_params
        lines.insert(
            3, f"  occlusion chain: p_v->o={float(op.p_occluded_visible):g}, "
               f"p_o->o={float(op.p_occluded_occluded):g}, "
               f"init={float(op.initial_occlusion_prob):g}")
    elif hasattr(c, "update_iterations"):
        head = (f"GaussianTracker (robust multi-sensor GF): "
                f"iterations={c.update_iterations}, "
                f"trust_sigma={c.trust_sigma:g}, "
                f"pixel_stride={tracker.pixel_stride}, "
                f"sigma_backend={c.sigma_backend}, "
                f"occlusion_memory={c.occlusion_memory}, "
                f"device={tracker.device}")
    else:
        head = type(tracker).__name__
    if getattr(c, "moving_average_update_rate", 1.0) != 1.0:
        lines.append(f"  output EMA rate={c.moving_average_update_rate:g}")
    return "\n".join([head] + lines)
