"""Frozen copy of ``dbot_ros_tpu_torch/ops/raycast.py`` (commit 8da1569), with its
imports pointed at the other frozen copies beside it. The benchmark's
reference computes with it; it imports nothing of the port, so later
changes to the port cannot move the yardstick.

The original docstring follows.

Batched depth rendering by ray-triangle intersection.

Port of ``dbot_ros_tpu/ops/raycast.py``: per pose, the transformed
Möller–Trumbore constants form a ``(3T, 3)`` matrix ``G`` so that
``rays (N, 3) @ Gᵀ`` gives ``[u_num | v_num | det]`` per triangle, and
``t = t_num / det`` is the z-depth of a z = 1 ray. Products run in full
float32 (TF32 stays off, PyTorch's default).

:func:`raycast_oracle` is the independent golden path (textbook
Möller–Trumbore on transformed vertices) that tests and
``runtime.sources.OracleSource`` render with.
"""

from __future__ import annotations

import torch

from . import se3
from .mesh import TriangleMesh

_DET_EPS = 1e-12
_NEAR = 1e-4
MISS_DEPTH = float("inf")


def pose_tri_constants(mesh: TriangleMesh, poses):
    """Transform object-frame constants by poses ``[..., 7]``.

    Returns ``(G, t_num)`` with ``G [..., T, 3, 3]`` stacking rows
    ``[g_u; g_v; g_det]`` and ``t_num [..., T]``.
    """
    R = se3.quat_to_matrix(se3.pose_quat(poses))          # [..., 3, 3]
    tau = se3.pose_trans(poses)[..., None, :]             # [..., 1, 3]

    def rot(x):  # rows x[t] → R x[t]
        return torch.einsum("...ij,tj->...ti", R, x)

    Rg_det = rot(mesh.g_det)
    Re1 = rot(mesh.tri_e1)
    Re2 = rot(mesh.tri_e2)
    g_u = rot(mesh.g_u) + se3._cross(tau, Re2)
    g_v = rot(mesh.g_v) - se3._cross(tau, Re1)
    t_num = mesh.t_num + torch.einsum("...ti,...i->...t", Rg_det,
                                      tau[..., 0, :])
    G = torch.stack([g_u, g_v, Rg_det], dim=-2)           # [..., T, 3, 3]
    return G, t_num


def _intersect_from_numerators(u_num, v_num, det, t_num, near=_NEAR,
                               slack=0.0):
    """Shared hit test: numerators → per-triangle ray parameter (inf = miss).

    Both windings hit (conditions multiplied through by sign(det)); no
    division before validity is known. ``slack`` relaxes the inside-test
    by that many barycentric units (candidate-set paths only).
    """
    s = torch.sign(det)
    adet = torch.abs(det)
    sa = slack * adet
    valid = ((adet > _DET_EPS)
             & (s * u_num >= -sa)
             & (s * v_num >= -sa)
             & (s * (u_num + v_num) <= adet + sa)
             & (s * t_num > near * adet))
    return torch.where(valid,
                       t_num / torch.where(adet > _DET_EPS, det, 1.0),
                       MISS_DEPTH)


def _chunked_constants(mesh: TriangleMesh, poses, tri_chunk: int):
    """Constants padded to a multiple of the chunk, split per chunk."""
    G, t_num = pose_tri_constants(mesh, poses)
    T = G.shape[-3]
    tri_chunk = min(tri_chunk, T)
    pad = (-T) % tri_chunk
    if pad:
        # degenerate triangles (g = 0 → det = 0 → never hit)
        G = torch.cat([G, G.new_zeros(G.shape[:-3] + (pad, 3, 3))], dim=-3)
        t_num = torch.cat([t_num, t_num.new_zeros(t_num.shape[:-1] + (pad,))],
                          dim=-1)
    return (torch.split(G, tri_chunk, dim=-3),
            torch.split(t_num, tri_chunk, dim=-1), tri_chunk)


def raycast_depth(mesh: TriangleMesh, poses, rays, tri_chunk: int = 512):
    """Depth per pixel for each pose: ``[..., N]`` (inf where no hit).

    ``rays``: ``(N, 3)`` z = 1 pixel rays; ``tri_chunk`` bounds live memory
    at ``batch × N × tri_chunk`` floats.
    """
    Gs, ts, _ = _chunked_constants(mesh, poses, tri_chunk)
    zmin = None
    for g, tn in zip(Gs, ts):
        g = g.reshape(g.shape[:-3] + (-1, 3))             # [..., 3Tc, 3]
        nums = torch.matmul(g, rays.T).transpose(-1, -2)   # [..., N, 3Tc]
        nums = nums.reshape(nums.shape[:-1] + (-1, 3))
        t = _intersect_from_numerators(
            nums[..., 0], nums[..., 1], nums[..., 2], tn[..., None, :])
        tmin = torch.min(t, dim=-1).values
        zmin = tmin if zmin is None else torch.minimum(zmin, tmin)
    return zmin


# the oracle's (rays, triangles) intermediates stay under this many bytes
ORACLE_BUDGET_BYTES = 256 << 20
# bytes per (ray, triangle) pair alive at once in one chunk: pvec and the
# product feeding each dot (2 × 12), det, u, v, t and their masks (~40)
_ORACLE_BYTES_PER_PAIR = 64


def raycast_oracle(mesh: TriangleMesh, pose, rays, near=_NEAR,
                   ray_chunk=None):
    """Golden-path raycast for one pose ``(7,)`` → depth ``(N,)`` (inf =
    miss): textbook Möller–Trumbore (pvec/qvec) on pose-transformed
    vertices, shared with neither :func:`raycast_depth` nor the kernels.

    Runs over ``ray_chunk`` rays at a time (default: as many as keep the
    chunk's intermediates under ``ORACLE_BUDGET_BYTES``, 256 MiB; a
    640×480 frame against 1408 triangles unchunked would need 5.2 GB
    for one ``(N, T, 3)`` intermediate alone).
    """
    v = se3.pose_apply(pose, mesh.vertices)               # (V, 3)
    a = v[mesh.faces[:, 0]]                               # (T, 3)
    e1 = v[mesh.faces[:, 1]] - a
    e2 = v[mesh.faces[:, 2]] - a
    tvec = -a                                             # origin at 0
    qvec = torch.linalg.cross(tvec, e1)                   # (T, 3)
    t_num = torch.sum(e2 * qvec, dim=-1)                  # (T,)
    T = a.shape[0]
    if ray_chunk is None:
        ray_chunk = max(1, ORACLE_BUDGET_BYTES
                        // (_ORACLE_BYTES_PER_PAIR * max(T, 1)))
    out = []
    for d in torch.split(rays, ray_chunk):
        pvec = torch.linalg.cross(d[:, None, :].expand(-1, T, 3),
                                  e2[None].expand(d.shape[0], T, 3))
        det = torch.sum(e1 * pvec, dim=-1)                # (C, T)
        u = torch.sum(tvec * pvec, dim=-1)
        del pvec
        vv = torch.sum(d[:, None, :] * qvec, dim=-1)
        # inside test multiplied through by sign(det): both windings hit
        s = torch.sign(det)
        adet = torch.abs(det)
        hit = ((adet > _DET_EPS) & (s * u >= 0) & (s * vv >= 0)
               & (s * (u + vv) <= adet) & (s * t_num > near * adet))
        t = torch.where(hit, t_num / torch.where(hit, det, 1.0), MISS_DEPTH)
        out.append(torch.min(t, dim=-1).values)
    return torch.cat(out)


def render_depth_image(mesh: TriangleMesh, poses, camera, tri_chunk=512):
    """Depth images ``[..., H, W]`` for poses, via the production raycast."""
    z = raycast_depth(mesh, poses, camera.rays, tri_chunk)
    return z.reshape(z.shape[:-1] + (camera.height, camera.width))
