"""Silhouette-overlay observability.

Port of ``dbot_ros_tpu/runtime/overlay.py``: render the estimated-pose
silhouette over the observed depth image and write a PNG, with no
display server and no plotting dependency (a minimal zlib PNG encoder).

Color code per frame:
  * grayscale: observed depth (near = bright, invalid = black);
  * colored boundary + tint: each tracked object's silhouette rendered
    at the estimated pose (palette per object);
  * a well-tracked object's outline hugs its depth blob; a lost one
    visibly floats off it.

Hook points: :func:`save_overlay` for one frame; :func:`make_overlay_hook`
returns an ``on_frame`` callback for ``node.run`` (CLI: ``--overlay-every
N --overlay-dir D``).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from dbot_ros_tpu_torch.ops.raycast import raycast_depth
from dbot_ros_tpu_torch.trackers.base import to_center_frame

# distinguishable object palette (RGB)
PALETTE = [(255, 64, 64), (64, 255, 96), (96, 128, 255), (255, 224, 64),
           (255, 96, 255), (64, 224, 255)]


def write_png(path: str, rgb: np.ndarray):
    """Write an (H, W, 3) uint8 array as a PNG (pure python + zlib)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(png)


def depth_to_gray(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth → (H, W) uint8: near = bright, invalid/far = dark."""
    d = np.asarray(depth, np.float32)
    valid = np.isfinite(d) & (d > 0)
    if valid.any():
        lo = float(np.percentile(d[valid], 2))
        hi = float(np.percentile(d[valid], 98))
        hi = max(hi, lo + 1e-3)
        t = np.clip((d - lo) / (hi - lo), 0.0, 1.0)
        g = (230.0 - 180.0 * t)
    else:
        g = np.zeros_like(d)
    return np.where(valid, g, 16.0).astype(np.uint8)


def _boundary(mask: np.ndarray) -> np.ndarray:
    """Mask boundary via 4-neighbor shift erosion."""
    er = mask.copy()
    er[1:, :] &= mask[:-1, :]
    er[:-1, :] &= mask[1:, :]
    er[:, 1:] &= mask[:, :-1]
    er[:, :-1] &= mask[:, 1:]
    return mask & ~er


def overlay_rgb(depth, silhouettes) -> np.ndarray:
    """Compose the overlay image.

    Args:
      depth: (H, W) observed depth (NaN invalid).
      silhouettes: list of (H, W) bool masks, one per object (the
        object's rendered footprint at its estimated pose).
    Returns (H, W, 3) uint8.
    """
    gray = depth_to_gray(depth)
    rgb = np.stack([gray] * 3, axis=-1).astype(np.float32)
    for k, mask in enumerate(silhouettes):
        mask = np.asarray(mask, bool)
        color = np.array(PALETTE[k % len(PALETTE)], np.float32)
        rgb[mask] = 0.65 * rgb[mask] + 0.35 * color[None, :]
        rgb[_boundary(mask)] = color
    return np.clip(rgb, 0, 255).astype(np.uint8)


def render_silhouettes(meshes, poses_model, camera):
    """Render each object's estimated-pose footprint → list of (H, W)
    bool numpy masks. ``poses_model`` is (K, 7) in the model frame (what
    ``tracker.track`` returns); rendering runs on the camera's device."""
    dev = camera.rays.device
    if not isinstance(poses_model, torch.Tensor):
        poses_model = np.asarray(poses_model, np.float32)
    poses_model = torch.as_tensor(poses_model, dtype=torch.float32,
                                  device=dev)
    if poses_model.ndim == 1:
        poses_model = poses_model[None]
    masks = []
    for k, mesh in enumerate(meshes):
        mesh = mesh.to(dev)
        pc = to_center_frame(poses_model[k], mesh.center)
        d = raycast_depth(mesh, pc, camera.rays, 128)
        masks.append(torch.isfinite(d).cpu().numpy().reshape(
            camera.height, camera.width))
    return masks


def save_overlay(path, meshes, camera, poses_model, depth):
    """Render + write one overlay PNG."""
    sil = render_silhouettes(meshes, poses_model, camera)
    write_png(path, overlay_rgb(np.asarray(depth).reshape(
        camera.height, camera.width), sil))


def make_overlay_hook(meshes, camera, out_dir: str, every: int = 1,
                      prefix: str = "frame"):
    """``on_frame(frame, poses, info)`` callback for ``node.run`` that
    writes ``{out_dir}/{prefix}_{index:05d}.png`` every ``every``-th
    frame."""
    os.makedirs(out_dir, exist_ok=True)
    failures = [0]

    def hook(frame, poses, info):
        if every <= 0 or frame.index % every or failures[0] >= 3:
            return
        try:
            save_overlay(
                os.path.join(out_dir, f"{prefix}_{frame.index:05d}.png"),
                meshes, camera, poses, frame.depth)
        except Exception as e:  # noqa: BLE001
            # observability must never kill the tracking loop (disk
            # full, dir removed, pose/mesh count mismatch, bad depth
            # shape); give up quietly after a few failures
            failures[0] += 1
            import sys
            print(f"overlay write failed ({e}); "
                  f"{'disabling' if failures[0] >= 3 else 'retrying'}",
                  file=sys.stderr)

    return hook
