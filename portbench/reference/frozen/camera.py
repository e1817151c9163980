"""Frozen copy of ``dbot_ros_tpu_torch/utils/camera.py`` (commit 8da1569), with its
imports pointed at the other frozen copies beside it. The benchmark's
reference computes with it; it imports nothing of the port, so later
changes to the port cannot move the yardstick.

The original docstring follows.

Camera model: intrinsics + precomputed z = 1 pixel rays.

Port of ``dbot_ros_tpu/utils/camera.py``. Depth is the camera-frame z
coordinate in meters (not ray length).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """Pinhole camera.

    Attributes:
      camera_matrix: (3, 3) float32 intrinsics K (already downsampled).
      rays: (H*W, 3) float32, ray direction per pixel with z = 1.
      height, width: downsampled resolution.
    """

    camera_matrix: torch.Tensor
    rays: torch.Tensor
    height: int
    width: int

    @property
    def num_pixels(self) -> int:
        return self.height * self.width

    def to(self, device) -> "CameraModel":
        return dataclasses.replace(self,
                                   camera_matrix=self.camera_matrix.to(device),
                                   rays=self.rays.to(device))


def make_camera(camera_matrix, height: int, width: int,
                downsampling: int = 1, device=None) -> CameraModel:
    """Build a CameraModel, optionally downsampling the intrinsics
    (fx, fy, cx, cy divided by the factor, resolution shrunk)."""
    K = np.asarray(camera_matrix, np.float64).reshape(3, 3).copy()
    if downsampling != 1:
        K[:2, :] /= float(downsampling)
        height //= downsampling
        width //= downsampling
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    rays = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
    return CameraModel(
        camera_matrix=torch.from_numpy(K.astype(np.float32)).to(device),
        rays=torch.from_numpy(
            rays.reshape(-1, 3).astype(np.float32)).to(device),
        height=int(height),
        width=int(width),
    )


def default_kinect_camera(downsampling: int = 8,
                          device=None) -> CameraModel:
    """Kinect-v1-class VGA intrinsics (the reference's default sensor)."""
    K = np.array([[525.0, 0.0, 319.5],
                  [0.0, 525.0, 239.5],
                  [0.0, 0.0, 1.0]])
    return make_camera(K, 480, 640, downsampling, device=device)


def preprocess_depth(depth, invalid_value: float = float("nan")):
    """Sanitize a raw depth image: nonpositive / NaN / inf → invalid_value."""
    depth = torch.as_tensor(depth, dtype=torch.float32)
    bad = ~torch.isfinite(depth) | (depth <= 0.0)
    return torch.where(bad, invalid_value, depth)
