"""Particle tracker facade + builder.

Port of ``dbot_ros_tpu/trackers/particle.py``: a host-side stateful
wrapper around the RBC-PF step that owns the belief, the random
generator, output smoothing and the model↔centre frame conversions
(``tracker.initialize(poses); tracker.track(depth)``).

Not ported yet: the island trial of two or more racing hypotheses and
its chain-free pose score (``initialize(hypotheses=...)`` with H ≥ 2
raises NotImplementedError).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from dbot_ros_tpu import config as cfg
from dbot_ros_tpu_torch.filters import rbcpf
from dbot_ros_tpu_torch.models import beam, occlusion, transition
from dbot_ros_tpu_torch.models.sensor import make_rb_sensor
from dbot_ros_tpu_torch.ops import resample as rs
from dbot_ros_tpu_torch.trackers import base
from dbot_ros_tpu_torch.utils import se3
from dbot_ros_tpu_torch.utils.camera import (CameraModel,
                                             default_kinect_camera,
                                             make_camera, preprocess_depth)
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh, load_obj


def build_camera(camera_cfg: cfg.CameraConfig, device=None) -> CameraModel:
    if camera_cfg.camera_matrix is None:
        return default_kinect_camera(camera_cfg.downsampling_factor,
                                     device=device)
    h, w = camera_cfg.resolution
    return make_camera(np.asarray(camera_cfg.camera_matrix, float), h, w,
                       camera_cfg.downsampling_factor, device=device)


def build_meshes(object_cfg: cfg.ObjectConfig,
                 device=None) -> List[TriangleMesh]:
    return [load_obj(p, center=object_cfg.center_object,
                     scale=object_cfg.scale, device=device)
            for p in object_cfg.mesh_paths()]


class ParticleTracker:
    """User-facing particle tracker (one or more rigid objects) on
    ``device`` (default: the CPU). Build from a config, or pass meshes
    and camera directly; they are moved to the device."""

    def __init__(self, config: cfg.ParticleTrackerConfig,
                 meshes: Optional[List[TriangleMesh]] = None,
                 camera: Optional[CameraModel] = None, device=None):
        self.config = config
        self.device = torch.device(device if device is not None else "cpu")
        camera = camera if camera is not None else build_camera(
            config.camera)
        self.camera = camera.to(self.device)
        meshes = meshes if meshes is not None else build_meshes(
            config.object)
        if not meshes:
            raise ValueError("particle tracker needs at least one mesh")
        self.meshes = [m.to(self.device) for m in meshes]

        obs = config.observation
        self.beam_params = beam.make_beam_params(
            tail_weight=obs.tail_weight, model_sigma=obs.model_sigma,
            sigma_factor=obs.sigma_factor, min_depth=obs.min_depth,
            max_depth=obs.max_depth, exponential_rate=obs.exponential_rate,
            device=self.device)
        self.occ_params = occlusion.make_occlusion_params(
            obs.p_occluded_visible, obs.p_occluded_occluded,
            obs.initial_occlusion_prob, device=self.device)
        tr = config.transition
        self.trans_params = transition.make_transition_params(
            tr.linear_acceleration_sigma, tr.angular_acceleration_sigma,
            tr.damping, device=self.device)
        self.sensor = make_rb_sensor(
            self.meshes, self.camera, self.beam_params, self.occ_params,
            frame_rate=config.camera.frame_rate, backend=config.backend,
            device=self.device, **(config.backend_options or {}))
        self._dt = 1.0 / config.camera.frame_rate
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.belief: Optional[rbcpf.ParticleBelief] = None
        self._smoothed = None  # (K, 7) centred-frame smoothed poses

    @property
    def centers(self):
        return torch.stack([m.center for m in self.meshes])  # (K, 3)

    def initialize(self, poses_model, hypotheses=None):
        """Set the initial object pose(s), in the original mesh frame, and
        re-seed the generator from ``config.seed``.

        ``hypotheses`` with two or more entries would start the island
        trial, which is not ported (NotImplementedError); with one entry
        they are ignored, as in the reference.
        """
        if hypotheses is not None and np.asarray(hypotheses).ndim >= 2 \
                and np.asarray(hypotheses).shape[0] >= 2:
            raise NotImplementedError(
                "island trials of >= 2 hypotheses are not ported yet "
                "(ROADMAP queue A, 'Island trials with _pose_score')")
        poses_model = torch.as_tensor(poses_model, dtype=torch.float32,
                                      device=self.device)
        if poses_model.ndim == 1:
            poses_model = poses_model[None]
        poses_center = base.to_center_frame(poses_model, self.centers)
        self.generator.manual_seed(self.config.seed)
        self.belief = rbcpf.init_belief(
            poses_center, self.config.evaluation_count,
            self.camera.num_pixels,
            float(self.occ_params.initial_occlusion_prob),
            sensor=self.sensor, generator=self.generator)
        self._smoothed = poses_center

    def restore(self, belief: rbcpf.ParticleBelief):
        """Resume from a saved belief. The tracker takes a copy of the
        occlusion map, which ``track`` updates in place, so ``belief``
        itself stays as it was."""
        occ = belief.occlusion
        occ = ((occ[0].clone(), *occ[1:]) if isinstance(occ, (tuple, list))
               else occ.clone())
        self.belief = dataclasses.replace(belief, occlusion=occ)
        ln, _ = rs.normalize_log_weights(belief.log_weights)
        mean = se3.states_mean(belief.states, torch.exp(ln))
        self._smoothed = mean[:, :7]

    def track(self, depth_image, dt=None):
        """One frame → (poses (K, 7) in the model frame, StepInfo).

        ``dt``: real interval since the previous frame in seconds (default
        1/frame_rate); transition noise and the occlusion chain scale
        with it.
        """
        if self.belief is None:
            raise RuntimeError("call initialize(poses) before track()")
        z = preprocess_depth(torch.as_tensor(
            depth_image, dtype=torch.float32,
            device=self.device).reshape(-1))
        dt = float(np.float32(self._dt if dt is None else dt))
        self.belief, info = rbcpf.rbcpf_step(
            self.belief, z, self.sensor, self.trans_params, dt,
            max_kl_divergence=self.config.max_kl_divergence,
            generator=self.generator)
        new_poses = info.mean_state[:, :7]
        self._smoothed = base.moving_average_pose(
            self._smoothed, new_poses,
            self.config.moving_average_update_rate)
        return base.to_model_frame(self._smoothed, self.centers), info
