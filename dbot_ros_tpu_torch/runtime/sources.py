"""Depth-frame sources: synthetic simulation.

Port of ``Frame`` and ``SyntheticSource`` from
``dbot_ros_tpu/runtime/sources.py``: render a scripted ground-truth
trajectory through the production raycaster and add sensor noise and
dropout, drawn from a ``torch.Generator`` seeded from ``seed``. Sources
iterate ``Frame(index, depth, ground_truth)``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from dbot_ros_tpu_torch.ops.raycast import raycast_depth
from dbot_ros_tpu_torch.trackers.base import to_center_frame
from dbot_ros_tpu_torch.utils.camera import CameraModel
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh


@dataclasses.dataclass
class Frame:
    index: int
    depth: np.ndarray          # (N,) or (H, W) float32, NaN = invalid
    ground_truth: Optional[np.ndarray] = None  # (K, 7) model-frame poses
    # frames dropped since the last one; None = pull source
    skipped: Optional[int] = None


class SyntheticSource:
    """Render a scripted ground-truth trajectory into noisy depth frames.

    ``trajectory_fn(t: int) → (K, 7)`` model-frame poses (host-side).
    Rendering and noise run on the camera's device; frames come out as
    flat (N,) numpy arrays, as in the reference.
    """

    def __init__(self, meshes, camera: CameraModel, trajectory_fn,
                 num_frames: int, noise_sigma: float = 0.003,
                 dropout_prob: float = 0.0, background_depth: float = 2.0,
                 seed: int = 0):
        if isinstance(meshes, TriangleMesh):
            meshes = [meshes]
        self.camera = camera
        self.device = camera.rays.device
        self.meshes = [m.to(self.device) for m in meshes]
        self.trajectory_fn = trajectory_fn
        self.num_frames = num_frames
        self.noise_sigma = noise_sigma
        self.dropout_prob = dropout_prob
        self.background_depth = background_depth
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def __len__(self):
        return self.num_frames

    def render(self, poses_model):
        """(K, 7) model-frame poses → noisy flat depth (N,) on the device."""
        depth = None
        for k, mesh in enumerate(self.meshes):
            pc = to_center_frame(poses_model[k], mesh.center)
            d = raycast_depth(mesh, pc, self.camera.rays)
            depth = d if depth is None else torch.minimum(depth, d)
        z = torch.where(torch.isfinite(depth), depth,
                        float(self.background_depth))
        if self.noise_sigma > 0:
            z = z + self.noise_sigma * torch.randn(
                z.shape, generator=self.generator, device=self.device)
        if self.dropout_prob > 0:
            drop = torch.rand(z.shape, generator=self.generator,
                              device=self.device) < self.dropout_prob
            z = torch.where(drop, float("nan"), z)
        return z

    def __iter__(self) -> Iterator[Frame]:
        for t in range(self.num_frames):
            poses = np.asarray(self.trajectory_fn(t), np.float32)
            if poses.ndim == 1:
                poses = poses[None]
            z = self.render(torch.as_tensor(poses, device=self.device))
            yield Frame(t, z.cpu().numpy(), poses)
