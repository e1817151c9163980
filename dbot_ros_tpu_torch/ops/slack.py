"""Candidate-coverage slack rule of the candidate-set renderers.

Port of ``dbot_ros_tpu/ops/slack.py``. A candidate-set renderer samples
triangle ids at the reference pose's pixel centres; a displaced
particle's ray can hit a face finer than a pixel that no centre named.
Accepting hits on a candidate's plane within a slack of its barycentric
footprint closes the gaps. The slack is ``bary_slack_px`` pixels of
footprint at the object's depth, in barycentric units of the object's
own mesh:

    slack_k = clip(bary_slack_px · pitch · z̄_k / median_edge(mesh_k), 0, 4)

with pitch = 1/fx (the horizontal z = 1 ray spacing), z̄_k the mean
camera-frame depth of object ``k``'s particles (or sigma points) and
``median_edge([mesh_k])`` its median triangle-edge length. Every
renderer of the port applies it per object: the fused sensor (one slack
per packed triangle, ops/fused_sensor.py), the sigma renderer and the
particle ``"deferred"`` renderer (ops/deferred.py).

Where this departs from the reference: its fused sensor and its sigma
renderer measure every mesh in the finest mesh's median edge and take
the deepest object's z̄, so in a scene of a fine and a coarse mesh the
coarse mesh's faces get the fine mesh's barycentric slack (PERF.md:
0.32 in place of 0.0506 for the eval suite's box beside the slice's
sphere, which widens the box's faces by ~1.7 cm). Its ``"deferred"``
renderer already applies the rule per object. With one object both rules
give the same number. A fixed ``bary_slack`` keeps the reference's
contract: one barycentric number for every mesh.
"""

from __future__ import annotations

import numpy as np
import torch

_MAX_SLACK = 4.0


def median_edge(meshes) -> float:
    """Min over meshes of the median triangle-edge length (pass one mesh,
    ``[m]``, for that mesh's own)."""
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
    """z̄ of each object: the mean of its camera-frame z over the cloud.

    ``z``: (P,) of one object → a 0-d tensor, or (P, K) → (K,); on ``z``'s
    device (no host read).
    """
    zbar = torch.mean(z[:, None] if z.ndim == 1 else z, dim=0)
    return zbar[0] if z.ndim == 1 else zbar


def auto_bary_slack(zbar, pitch: float, med_edge: float,
                    bary_slack_px: float = 0.25):
    """The automatic rule for one object at depth ``zbar`` with median
    edge ``med_edge``, clipped to keep the inside-test sane."""
    return torch.clamp(bary_slack_px * pitch * zbar / med_edge,
                       0.0, _MAX_SLACK)
