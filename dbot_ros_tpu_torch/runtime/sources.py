"""Depth-frame sources: recorded replay and synthetic simulation.

Port of ``Frame``, ``ReplaySource``, ``record_npz``, ``SyntheticSource``
and ``scale_camera`` from ``dbot_ros_tpu/runtime/sources.py``.
:class:`ReplaySource` replays an ``.npz``/``.npy`` depth stack (the file
format is the reference's, so a recording made by either package replays
in the other); :class:`SyntheticSource` renders a scripted ground-truth
trajectory through the production raycaster and adds sensor noise and
dropout, drawn from a ``torch.Generator`` seeded from ``seed``. Sources
iterate ``Frame(index, depth, ground_truth)``.

Not ported yet: ``OracleSource``, ``ThreadedSource`` and
``U16CameraAdapter`` (constructing one raises NotImplementedError).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from dbot_ros_tpu_torch.ops.raycast import raycast_depth
from dbot_ros_tpu_torch.trackers.base import to_center_frame
from dbot_ros_tpu_torch.utils.camera import CameraModel, make_camera
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh


@dataclasses.dataclass
class Frame:
    index: int
    depth: np.ndarray          # (N,) or (H, W) float32, NaN = invalid
    ground_truth: Optional[np.ndarray] = None  # (K, 7) model-frame poses
    # frames dropped since the last one; None = pull source
    skipped: Optional[int] = None


class ReplaySource:
    """Replay a recorded depth sequence from .npz/.npy.

    Accepted layouts:
      * .npz with ``depth`` (T, H, W) and optional ``poses`` (T, K, 7);
      * .npy with just the (T, H, W) depth stack.
    Depth in meters, NaN/0/negative = invalid. Frames stay numpy arrays
    on the host; the tracker moves each to its device.
    """

    def __init__(self, path: str):
        if str(path).endswith(".npz"):
            data = np.load(path)
            self.depth = np.asarray(data["depth"], np.float32)
            self.poses = (np.asarray(data["poses"], np.float32)
                          if "poses" in data else None)
        else:
            self.depth = np.asarray(np.load(path), np.float32)
            self.poses = None
        if self.depth.ndim != 3:
            raise ValueError(f"depth stack must be (T, H, W), "
                             f"got {self.depth.shape}")

    def __len__(self):
        return self.depth.shape[0]

    def __iter__(self) -> Iterator[Frame]:
        for t in range(len(self)):
            gt = self.poses[t] if self.poses is not None else None
            yield Frame(t, self.depth[t], gt)


def record_npz(path: str, depth_stack, poses=None):
    """Write a replay file: ``depth`` (T, H, W) and optional ``poses``."""
    arrays = {"depth": np.asarray(depth_stack, np.float32)}
    if poses is not None:
        arrays["poses"] = np.asarray(poses, np.float32)
    np.savez_compressed(path, **arrays)


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


def scale_camera(camera: CameraModel, factor: int) -> CameraModel:
    """A camera with ``factor``× the resolution and intrinsics: the native
    sensor grid whose strided downsample lands back on ``camera``."""
    K = camera.camera_matrix.detach().cpu().numpy().astype(np.float64)
    K[:2, :] *= factor
    return make_camera(K, camera.height * factor, camera.width * factor,
                       device=camera.rays.device)


def _not_ported(name: str):
    class NotPorted:
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP queue A, 'What the "
                "first slices left out': the oracle, threaded and u16 "
                "sources)")

    NotPorted.__name__ = NotPorted.__qualname__ = name
    return NotPorted


OracleSource = _not_ported("OracleSource")
ThreadedSource = _not_ported("ThreadedSource")
U16CameraAdapter = _not_ported("U16CameraAdapter")
