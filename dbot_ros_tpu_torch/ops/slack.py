"""Candidate-coverage slack rule of the fused sensor.

Port of ``dbot_ros_tpu/ops/slack.py``: ``slack = bary_slack_px ·
pitch · z̄ / median_edge``, with pitch = 1/fx (the horizontal z = 1 ray
spacing), z̄ = the particle cloud's mean depth (max over objects) and the
finest mesh's median edge length, clipped to [0, 4].
"""

from __future__ import annotations

import numpy as np
import torch

_MAX_SLACK = 4.0


def median_edge(meshes) -> float:
    """Min over meshes of the median triangle-edge length."""
    edges = []
    for m in meshes:
        e1 = m.tri_e1[:m.num_triangles].detach().cpu().numpy()
        e2 = m.tri_e2[:m.num_triangles].detach().cpu().numpy()
        ln = np.concatenate([np.linalg.norm(e1, axis=1),
                             np.linalg.norm(e2, axis=1)])
        ln = ln[ln > 0]
        edges.append(float(np.median(ln)) if ln.size else 1.0)
    return max(min(edges), 1e-6)


def ray_pitch(rays, height: int, width: int) -> float:
    """Horizontal pixel pitch of the z=1 rays (1/fx for a pinhole camera)."""
    rr = torch.as_tensor(rays).detach().cpu().numpy().reshape(
        height, width, 3)
    return float(np.median(np.abs(np.diff(rr[..., 0], axis=1))))


def cloud_depth(z):
    """z̄ of a particle cloud: per-object mean depth, max over objects.

    ``z``: (P,) or (P, K) camera-frame z coordinates; returns a 0-d tensor
    on their device (no host read).
    """
    if z.ndim == 1:
        z = z[:, None]
    return torch.max(torch.mean(z, dim=0))


def auto_bary_slack(zbar, pitch: float, med_edge: float,
                    bary_slack_px: float = 0.25):
    """The shared auto rule, clipped to keep the inside-test sane."""
    return torch.clamp(bary_slack_px * pitch * zbar / med_edge,
                       0.0, _MAX_SLACK)
