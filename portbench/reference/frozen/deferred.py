"""Frozen copy of ``dbot_ros_tpu_torch/ops/deferred.py`` (commit 8da1569), with its
imports pointed at the other frozen copies beside it. The benchmark's
reference computes with it; it imports nothing of the port, so later
changes to the port cannot move the yardstick.

The original docstring follows.

Deferred (candidate-set) raycast: the candidate pass of the fused
sensor, the sigma-point renderer of the Gaussian filter and the particle
filter's ``"deferred"`` renderer.

Port of ``dbot_ros_tpu/ops/deferred.py``. One exact raycast at a
reference pose gives each pixel its nearest triangle id; each pixel's K
candidates are its own id plus ids sampled from its neighbourhood. The
poses of a batch (particles, or the sigma points of a Gaussian belief)
are small perturbations of the reference, so each pixel is intersected
with its K candidate triangles only instead of the whole mesh.

The per-candidate constants are selected either by a one-hot product
(:func:`deferred_depth`, the reference's route for its matrix unit) or by
a direct gather (:func:`deferred_depth_gather`); both give the same
depths, and both renderers use the gather (the faster on an H100 at
either size, PERF.md). Products run in full float32 (TF32 stays off,
PyTorch's default). Nothing here reads a value back to the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import raycast
from .mesh import TriangleMesh


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


# the eight sampling directions of candidate_ids_dynamic, in preference
# order (axis-aligned first, then diagonal)
_DIRECTIONS = ((0, 1), (0, -1), (1, 0), (-1, 0),
               (1, 1), (-1, -1), (1, -1), (-1, 1))


@functools.lru_cache(maxsize=8)
def _ring_constants(device):
    """The ring factors, the least radii and the directions as tensors,
    built once per device (a constant built per call would be a copy
    from the host on every call)."""
    return (torch.tensor([1 / 3, 2 / 3, 1.0], dtype=torch.float32,
                         device=device),
            torch.tensor([1.0, 2.0, 3.0], device=device),
            torch.tensor(_DIRECTIONS, dtype=torch.int64, device=device))


def candidate_ids_dynamic(ids, height: int, width: int, spread_px,
                          num_candidates: int = 6,
                          num_triangles: int = 4094):
    """Spread-adaptive candidate ids (N, K): the sampling offsets scale
    with the sigma cloud's pixel footprint ``spread_px`` (a float or a
    0-d tensor on the device; never read back).

    Three rings at ``round(spread·{⅓,⅔,1})`` pixels (at least 1, 2, 3;
    spread clipped to [1, half the larger image side]) are sampled in the
    eight directions, border-clamped; a sample that missed falls back to
    the pixel's own id. Each pixel keeps its first K distinct ids in
    preference order (own id, then direction-major, radius-minor); slots
    left over repeat the own id. The table equals the reference's entry
    for entry; the route differs (a gather of clamped indices instead of
    dynamic slices of an edge-padded image).
    """
    dev = ids.device
    ids = ids.to(torch.int64)
    pad = max(1, int(0.5 * max(height, width)))
    spread = torch.as_tensor(spread_px, dtype=torch.float32, device=dev)
    spread = torch.clamp(spread, 1.0, float(pad))
    factors, floor_r, dirs = _ring_constants(dev)
    # torch.round, like the reference's, rounds half to even
    radii = torch.maximum(torch.round(spread * factors),
                          floor_r).to(torch.int64)               # (3,)
    off = (dirs[:, None, :] * radii[None, :, None]).reshape(-1, 2)  # (24, 2)
    yy = torch.arange(height, device=dev)[None, :, None]
    xx = torch.arange(width, device=dev)[None, None, :]
    y = torch.clamp(yy + off[:, 0, None, None], 0, height - 1)
    x = torch.clamp(xx + off[:, 1, None, None], 0, width - 1)
    shifted = ids[(y * width + x).reshape(off.shape[0], -1)]      # (24, N)
    shifted = torch.where(shifted >= 0, shifted, ids[None])
    stack = torch.cat([ids[None], shifted], dim=0).T              # (N, C)
    C = stack.shape[1]

    # Sort 1: key = (value, preference rank): duplicates adjacent, the
    # earliest-preference occurrence first.
    col = torch.arange(C, device=dev)[None, :]
    skey = torch.sort((stack + 1) * C + col, dim=1).values
    sv = skey // C                              # value + 1, sorted
    scol = skey % C                             # preference rank
    firsts = torch.cat([torch.ones_like(sv[:, :1], dtype=torch.bool),
                        sv[:, 1:] != sv[:, :-1]], dim=1)
    # Sort 2: key = (first-occurrence preference rank, value): the K
    # smallest entries per pixel are the K preferred distinct ids.
    vbits = 1 << max(12, int(num_triangles + 2).bit_length())
    key2 = torch.where(firsts, scol, C + 1) * vbits + sv
    key2 = torch.sort(key2, dim=1).values[:, :num_candidates]
    cand = key2 % vbits - 1                     # (N, K) candidate ids
    # unfilled slots (fewer than K distinct ids) repeat the own id
    return torch.where(key2 >= (C + 1) * vbits, stack[:, 0:1], cand)


def one_hot_selectors(cand, num_triangles: int):
    """Candidate ids (N, K) → K one-hot matrices (K, N, T), float32.

    A miss (-1) gives an all-zero row → selected constants are zero →
    det = 0 → no hit, mirroring the mesh-padding convention.
    """
    tri = torch.arange(num_triangles, device=cand.device)
    return (cand.T[..., None] == tri).to(torch.float32)


def _packed_constants(mesh: TriangleMesh, poses):
    """Per-pose constants, component-major: (10, T, P) with rows
    ``[g_u (3) | g_v (3) | g_det (3) | t_num]``."""
    G, t_num = raycast.pose_tri_constants(mesh, poses)    # (P,T,3,3),(P,T)
    P, T = t_num.shape
    packed = torch.cat([G.reshape(P, T, 9), t_num[..., None]], dim=-1)
    return packed.permute(2, 1, 0).contiguous()


def _min_candidate_depth(comp, rays, pixel_dim: int, bary_slack):
    """Nearest hit over each pixel's candidates → depth (P, N).

    ``comp``: the ten selected constants, each (N, K, P) (``pixel_dim``
    0) or (K, N, P) (``pixel_dim`` 1); rays (N, 3).
    """
    shape = [1, 1, 1]
    shape[pixel_dim] = -1
    rx, ry, rz = (rays[:, d].reshape(shape) for d in range(3))
    nums = [comp[3 * i] * rx + comp[3 * i + 1] * ry + comp[3 * i + 2] * rz
            for i in range(3)]
    t = raycast._intersect_from_numerators(nums[0], nums[1], nums[2],
                                           comp[9], slack=bary_slack)
    return torch.min(t, dim=1 - pixel_dim).values.T          # (P, N)


def deferred_depth(mesh: TriangleMesh, poses, rays, selectors,
                   bary_slack=0.0):
    """Depth for a pose batch via candidate one-hot products.

    Args:
      poses: (P, 7).
      rays: (N, 3).
      selectors: (K, N, T) one-hot candidate selectors (one_hot_selectors).
      bary_slack: barycentric slack of the inside-test (a float or a 0-d
        tensor).
    Returns:
      depth (P, N), inf = miss (w.r.t. the candidate sets).
    """
    packed = _packed_constants(mesh, poses)               # (10, T, P)
    _, T, P = packed.shape
    K, N, _ = selectors.shape
    # all K candidate sets in one product: (K·N, T) @ (T, 10·P)
    sel = selectors.reshape(K * N, T) @ packed.transpose(0, 1).reshape(
        T, 10 * P)
    return _min_candidate_depth(sel.reshape(K, N, 10, P).unbind(2), rays,
                                1, bary_slack)


def deferred_depth_gather(mesh: TriangleMesh, poses, rays, cand,
                          bary_slack=0.0):
    """Candidate-set depth via a direct gather of the per-candidate
    constants: the same depths as :func:`deferred_depth` with no product.

    Args:
      cand: (N, K) candidate triangle ids; -1 = none. A miss is routed to
        the mesh's last row, which ``make_mesh`` guarantees to be a
        degenerate padding triangle (det 0 → never a hit).
    Returns: depth (P, N), inf = miss w.r.t. the candidate sets.
    """
    packed = _packed_constants(mesh, poses)               # (10, T, P)
    _, T, P = packed.shape
    N, K = cand.shape
    safe = torch.where(cand >= 0, cand, T - 1).reshape(-1)
    sel = packed.index_select(1, safe).reshape(10, N, K, P)
    return _min_candidate_depth(sel.unbind(0), rays, 0, bary_slack)


def make_sigma_renderer(meshes, rays, height: int, width: int,
                        pixel_idx=None, radius: int = 3,
                        num_candidates: int = 6, tri_chunk: int = 512,
                        bary_slack: float = None,
                        bary_slack_px: float = 0.25):
    """Candidate-set renderer for *sigma-point* batches (the Gaussian
    filter's hot path).

    Returns ``render_fn(poses)`` matching the filter's render contract
    (filters/rgf.py ``update``: poses (S, 7) single-object | (S, K, 7)
    scene → depth (S, n_sub); inf = miss). Sigma point 0 is the mean
    (ops/sigma_points.py: deltas[0] = 0), so ``poses[0]`` is the reference
    pose of each call: the exact reference pass runs at the current
    iterate, and the candidate rings only have to cover the sigma spread
    around it.

    Args:
      meshes: list of TriangleMesh (K objects; min-depth composition).
      rays: the full camera ray grid (N, 3): the reference pass and the
        candidate rings need image structure even when the update runs on
        a pixel subset.
      pixel_idx: optional (n_sub,) indices into the flattened grid (the
        tracker's ``pixel_stride`` subset); None = all pixels.
      radius: least candidate ring radius in pixels; the rings scale with
        the sigma cloud's pixel footprint per call.
      num_candidates: candidate triangle ids per pixel.
      bary_slack: one barycentric slack for every mesh; None = the
        automatic rule per object (ops/slack.py): ``bary_slack_px``
        pixels at the mean depth of object ``k``'s sigma points, in
        units of mesh ``k``'s median edge (the reference takes the
        finest mesh's for every mesh).
    """
    from . import slack as slack_mod
    from . import se3

    pitch = slack_mod.ray_pitch(rays, height, width)
    med_edges = [slack_mod.median_edge([m]) for m in meshes]
    rays_sub = rays if pixel_idx is None else rays[pixel_idx]
    meshes = list(meshes)
    bound_r = [float(np.linalg.norm(
        m.vertices.detach().cpu().numpy(), axis=1).max()) for m in meshes]
    half_side = 0.5 * max(height, width)

    def render(poses):
        single = poses.ndim == 2
        depth = None
        for k, m in enumerate(meshes):
            p = poses if single else poses[:, k, :]
            _, ids = raycast_ids(m, p[0], rays, tri_chunk)
            # sigma-cloud pixel footprint: worst translation offset plus
            # worst rotation angle × mesh bounding radius, in pixels at
            # the reference depth
            t_spread = torch.max(torch.linalg.norm(p[:, :3] - p[0, :3],
                                                   dim=-1))
            ang = torch.max(torch.linalg.norm(
                se3.quat_boxminus(p[:, 3:7], p[0:1, 3:7]), dim=-1))
            z0 = torch.clamp_min(p[0, 2], 0.2)
            spread_px = torch.clamp(
                (t_spread + ang * bound_r[k]) / (pitch * z0),
                float(radius), half_side)
            cand = candidate_ids_dynamic(ids, height, width, spread_px,
                                         num_candidates,
                                         m.padded_triangles)
            if pixel_idx is not None:
                cand = cand[pixel_idx]
            if bary_slack is not None:
                slack = float(bary_slack)
            else:
                slack = slack_mod.auto_bary_slack(
                    slack_mod.cloud_depth(p[..., 2]), pitch, med_edges[k],
                    bary_slack_px)
            d = deferred_depth_gather(m, p, rays_sub, cand, slack)
            depth = d if depth is None else torch.minimum(depth, d)
        return depth

    return render


def make_deferred_renderer(mesh: TriangleMesh, rays, height: int,
                           width: int, radius: int = 2,
                           num_candidates: int = 4, tri_chunk: int = 512,
                           bary_slack: float = None,
                           bary_slack_px: float = 0.25):
    """The particle filter's candidate-set renderer.

    Returns ``render(reference_pose, poses (P, 7), cand=None, slack=None)
    → depth (P, N)`` and, as ``render.candidates(reference_pose)`` and
    ``render.slack(poses)``, its two per-frame parts, so that a caller
    rendering the particles in chunks computes them once for all chunks.

    ``bary_slack=None`` derives the slack per frame as ``bary_slack_px``
    pixels of footprint at the cloud's depth, in barycentric units of the
    mesh's median edge (the fused sensor's rule, ops/slack.py); pass
    ``bary_slack=0.0`` for the exact inside-test.
    """
    from . import slack as slack_mod

    pitch = slack_mod.ray_pitch(rays, height, width)   # == 1/fx
    med_edge = slack_mod.median_edge([mesh])

    def candidates(reference_pose):
        _, ids = raycast_ids(mesh, reference_pose, rays, tri_chunk)
        return candidate_ids(ids, height, width, radius, num_candidates)

    def slack_of(poses):
        if bary_slack is not None:
            return float(bary_slack)
        return slack_mod.auto_bary_slack(
            slack_mod.cloud_depth(poses[..., 2]), pitch, med_edge,
            bary_slack_px)

    def render(reference_pose, poses, cand=None, slack=None):
        if cand is None:
            cand = candidates(reference_pose)
        if slack is None:
            slack = slack_of(poses)
        return deferred_depth_gather(mesh, poses, rays, cand, slack)

    render.candidates = candidates
    render.slack = slack_of
    return render
