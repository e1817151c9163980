"""Candidate pass of the fused sensor: reference raycast ids + dilation.

Port of ``raycast_ids`` and ``candidate_ids`` from
``dbot_ros_tpu/ops/deferred.py``. One exact raycast at a reference pose
gives each pixel its nearest triangle id; each pixel's K candidates are
its own id plus ids sampled from a (2r+1)² neighbourhood. Particles are
small perturbations of the reference, so their hits fall in that set.
"""

from __future__ import annotations

import torch

from dbot_ros_tpu_torch.ops import raycast
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh


def raycast_ids(mesh: TriangleMesh, pose, rays, tri_chunk: int = 512):
    """Exact raycast of one pose → (depth (N,), tri_id (N,) int64, -1=miss).

    Ties go to the lowest triangle id (first minimum), as in the reference.
    """
    Gs, ts, chunk = raycast._chunked_constants(mesh, pose, tri_chunk)
    N = rays.shape[0]
    z = torch.full((N,), raycast.MISS_DEPTH, dtype=torch.float32,
                   device=rays.device)
    ids = torch.full((N,), -1, dtype=torch.int64, device=rays.device)
    for c, (g, tn) in enumerate(zip(Gs, ts)):
        nums = (rays @ g.reshape(-1, 3).T).reshape(N, -1, 3)
        t = raycast._intersect_from_numerators(
            nums[..., 0], nums[..., 1], nums[..., 2], tn[None, :])
        tbest, ibest = torch.min(t, dim=-1)
        better = tbest < z
        z = torch.where(better, tbest, z)
        ids = torch.where(better, ibest + c * chunk, ids)
    return z, torch.where(torch.isfinite(z), ids, -1)


def candidate_ids(ids, height: int, width: int, radius: int = 2,
                  num_candidates: int = 4):
    """Per-pixel candidate triangle ids (N, K) from the reference ids.

    Candidates = own id + ids sampled at increasing offsets (axis-aligned
    and diagonal), deduplicated against slot 0 only. Miss pixels (-1)
    inherit neighbours. Shifts wrap at the image edges (``torch.roll``,
    as ``jnp.roll`` in the reference).
    """
    img = ids.reshape(height, width)

    offsets = [(0, 0)]
    for r in range(1, radius + 1):
        offsets += [(0, r), (0, -r), (r, 0), (-r, 0),
                    (r, r), (-r, -r), (r, -r), (-r, r)]
    cand = []
    for dy, dx in offsets:
        s = torch.roll(img, shifts=(dy, dx), dims=(0, 1))
        # prefer a *valid* id: if the shifted pixel missed, keep own id
        cand.append(torch.where(s >= 0, s, img))
    stack = torch.stack(cand, dim=-1).reshape(ids.shape[0], -1)

    out = [stack[:, 0]]
    taken = stack[:, 0:1]
    for j in range(1, stack.shape[1]):
        if len(out) >= num_candidates:
            break
        col = stack[:, j]
        dup = torch.any(col[:, None] == taken, dim=1)
        pick = torch.where(dup, out[0], col)
        out.append(pick)
        taken = torch.cat([taken, pick[:, None]], dim=1)
    while len(out) < num_candidates:
        out.append(out[0])
    return torch.stack(out[:num_candidates], dim=-1)  # (N, K)
