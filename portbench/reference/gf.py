"""Plain PyTorch reference of one step of the Gaussian tracker: the
robust multi-sensor Gaussian filter (Issac et al., ICRA 2016), the
benchmark's yardstick for the Gaussian cells.

The step is the frozen ``rgf.rgf_step`` (the UKF prediction through the
damped-Wiener dynamics, then the iterated sigma-point update with the
body/background/occluder responsibilities, the trust-region steps and the
temporal occlusion memory), rendering through the frozen
``deferred.make_sigma_renderer`` (one exact raycast at each iterate, each
sigma pose against its pixel's candidate triangles) on the pixel subset
the configuration's ``pixel_stride`` gives (0: the frozen budget rule).
The filter is deterministic, so the step needs nothing but the belief
and the frame. Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .frozen import beam, deferred, occlusion, rgf
from .frozen.transition import make_transition_params
from . import scene
from .pf import precision


def pixel_stride(num_pixels: int, padded_triangles: int, num_objects: int,
                 iterations: int, budget_gflops: float = 5.0,
                 max_stride: int = 64) -> int:
    """Frozen copy of ``dbot_ros_tpu_torch/ops/budget.py``
    ``rgf_pixel_stride``: the smallest power-of-two stride that keeps the
    sigma-point raycast of a frame under ``budget_gflops``."""
    n_sigma = 2 * 12 * num_objects + 1
    per_px = n_sigma * padded_triangles * (iterations + 1) * 60
    total = per_px * num_pixels
    stride = 1
    while total / stride > budget_gflops * 1e9 and stride < max_stride:
        stride *= 2
    return stride


class GaussianReference:
    """The reference of ``config`` (the tracker's configuration as a
    dict) with the mesh ``obj_text``, on ``device``."""

    def __init__(self, config: dict, obj_text: str, device):
        self.device = torch.device(device)
        self.config = config
        self.mesh = scene.object_mesh(
            obj_text, config["object"].get("center_object", True),
            self.device)
        self.camera = scene.camera_for(config["camera"], self.device)
        cam = self.camera
        stride = int(config["pixel_stride"])
        if stride <= 0:
            stride = pixel_stride(cam.num_pixels,
                                  self.mesh.padded_triangles, 1,
                                  int(config["update_iterations"]))
        self.stride = max(stride, 1)
        self.pixel_idx = (None if self.stride == 1 else torch.arange(
            0, cam.num_pixels, self.stride, device=self.device))
        self.render_fn = deferred.make_sigma_renderer(
            [self.mesh], cam.rays, cam.height, cam.width,
            pixel_idx=self.pixel_idx, radius=int(config["sigma_radius"]),
            num_candidates=int(config["sigma_candidates"]))
        obs = config["observation"]
        self.bp = beam.make_beam_params(
            tail_weight=obs["tail_weight"], model_sigma=obs["model_sigma"],
            sigma_factor=obs["sigma_factor"], min_depth=obs["min_depth"],
            max_depth=obs["max_depth"],
            exponential_rate=obs["exponential_rate"], device=self.device)
        tr = config["transition"]
        self.trans = make_transition_params(
            tr["linear_acceleration_sigma"], tr["angular_acceleration_sigma"],
            tr["damping"], device=self.device)
        self.occ = (occlusion.make_occlusion_params(
            obs["p_occluded_visible"], obs["p_occluded_occluded"],
            obs["initial_occlusion_prob"], device=self.device)
            if config["occlusion_memory"] else None)
        self.frame_rate = float(config["camera"]["frame_rate"])

    def frame(self, depth):
        z = scene.preprocess(torch.as_tensor(depth, device=self.device))
        return z if self.pixel_idx is None else z[self.pixel_idx]

    def initial(self, pose_model, first_frame) -> rgf.GaussianBelief:
        """The tracker's initial belief about the model-frame pose, its
        background map seeded from ``first_frame``."""
        c = self.config
        pose = torch.as_tensor(np.asarray(pose_model, np.float32),
                               device=self.device).reshape(7)
        pc = scene.to_center_frame(pose, self.mesh.center)
        return rgf.init_belief(
            pc, num_pixels=int(self.frame(first_frame).shape[0]),
            first_frame=self.frame(first_frame),
            pos_sigma=c["init_pos_sigma"], rot_sigma=c["init_rot_sigma"],
            vel_sigma=c["init_vel_sigma"],
            background_depth=float(c["observation"]["max_depth"]),
            initial_occlusion_prob=(
                float(c["observation"]["initial_occlusion_prob"])
                if c["occlusion_memory"] else None), device=self.device)

    @staticmethod
    def from_program(belief) -> rgf.GaussianBelief:
        """A belief the tracker holds, copied, values unchanged."""
        return rgf.GaussianBelief(
            mean=belief.mean.float().clone(), cov=belief.cov.float().clone(),
            background=belief.background.float().clone(),
            occ_prior=(None if belief.occ_prior is None
                       else belief.occ_prior.float().clone()))

    def step(self, bel, depth, dt, dtype: str = "float32"):
        """One step of ``bel`` on ``depth`` over ``dt`` seconds →
        (new belief, model-frame pose (1, 7), step info), computed in
        ``dtype`` (``float32``, or the control's ``tf32``)."""
        c = self.config
        dt_t = torch.full((), float(np.float32(dt)), dtype=torch.float32,
                          device=self.device)
        with precision(dtype):
            new, info = rgf.rgf_step(
                bel, self.frame(depth), render_fn=self.render_fn,
                trans_params=self.trans, dt=dt_t, bp=self.bp,
                iterations=int(c["update_iterations"]),
                trust_sigma=float(c["trust_sigma"]),
                lin_floor_pos=float(c["lin_floor_pos"]),
                lin_floor_rot=float(c["lin_floor_rot"]),
                lin_cap_pos=float(c["lin_cap_pos"]),
                lin_cap_rot=float(c["lin_cap_rot"]),
                bg_sigma=float(c["bg_sigma"]), occ_params=self.occ,
                occ_dt_frames=dt_t * self.frame_rate, learn_world=True)
        pose = scene.to_model_frame(new.mean[None, :7], self.mesh.center)
        return new, pose, info
