"""Automatic pose initialization from a depth frame.

Port of ``dbot_ros_tpu/runtime/initializer.py``: a coarse 6-DoF search
that needs no operator.

Pipeline:
  1. Foreground segmentation: valid pixels inside a depth band → 3-D
     points via the camera rays; the robust (median) centroid seeds the
     candidate positions.
  2. Orientation candidates: a fixed coverage set of rotations
     (icosahedron vertex axes × spins).
  3. Every candidate pose is scored with the same beam-model image
     log-likelihood the trackers use (models/image_loglik.py): candidates
     are a particle batch through ops/raycast.
  4. An orientation-diverse beam of the best candidates is refined by an
     annealed random search and polished by per-axis line searches; the
     best refined pose becomes the initial pose.

The search's deterministic local stage (:func:`align_poses`,
:func:`polish_poses`) also re-anchors a running tracker on the newest
frame after a long frame gap (:func:`reanchor_tracker`), seeded from the
poses it holds.

All tensors live on the camera's device. The refinement's random numbers
come from a ``torch.Generator``, or are passed in (``draws``), which is
how the tests hold the search against the JAX package's.
"""

from __future__ import annotations

import inspect
import itertools

import numpy as np
import torch

from dbot_ros_tpu_torch.models import beam as beam_mod
from dbot_ros_tpu_torch.models import occlusion as occ_mod
from dbot_ros_tpu_torch.models.image_loglik import image_loglik
from dbot_ros_tpu_torch.ops.budget import xla_tri_chunk
from dbot_ros_tpu_torch.ops.raycast import MISS_DEPTH, raycast_depth
from dbot_ros_tpu_torch.trackers import base
from dbot_ros_tpu_torch.utils import se3
from dbot_ros_tpu_torch.utils.camera import CameraModel, preprocess_depth
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh, icosphere_mesh

# refined beams carried through the local search
BEAM = 8
# per-axis rotation offsets of the polish line search [rad]
POLISH_OFFSETS = (-0.12, -0.06, -0.03, -0.015, -0.0075, 0.0,
                  0.0075, 0.015, 0.03, 0.06, 0.12)


def orientation_candidates(n_axes: int = 12, n_spins: int = 4, device=None):
    """Coverage set of rotations: icosahedron axes × in-plane spins."""
    ico = icosphere_mesh(radius=1.0, subdivisions=0, center=False)
    axes = ico.vertices[:ico.num_vertices].numpy().astype(np.float64)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    axes = axes[:n_axes]
    quats = []
    for ax in axes:
        # rotation taking +z to ax
        z = np.array([0.0, 0.0, 1.0])
        v = np.cross(z, ax)
        s = np.linalg.norm(v)
        c = float(np.dot(z, ax))
        if s < 1e-8:
            qbase = np.array([1.0, 0, 0, 0]) if c > 0 else \
                np.array([0.0, 1.0, 0, 0])
        else:
            angle = np.arctan2(s, c)
            qbase = np.concatenate([[np.cos(angle / 2)],
                                    np.sin(angle / 2) * v / s])
        for k in range(n_spins):
            spin = 2 * np.pi * k / n_spins
            qspin = np.array([np.cos(spin / 2), 0, 0, np.sin(spin / 2)])
            # compose: base ∘ spin(z)
            w1, x1, y1, z1 = qbase
            w2, x2, y2, z2 = qspin
            quats.append([
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ])
    return torch.as_tensor(np.array(quats), dtype=torch.float32,
                           device=device)


def nanmedian(x, dim: int):
    """Median over the non-NaN entries along ``dim``; the mean of the two
    middle values for an even count (NumPy's and JAX's rule;
    ``torch.nanmedian`` returns the lower one), NaN for an empty set."""
    count = torch.sum(~torch.isnan(x), dim=dim, keepdim=True)
    ordered = torch.sort(x, dim=dim).values          # NaN sorts last
    lo = torch.clamp((count - 1) // 2, min=0)
    hi = count // 2
    mid = 0.5 * torch.gather(ordered, dim, lo) \
        + 0.5 * torch.gather(ordered, dim, hi)
    return torch.where(count > 0, mid, float("nan")).squeeze(dim)


def _depth_on(depth, camera: CameraModel):
    return preprocess_depth(torch.as_tensor(
        depth, dtype=torch.float32, device=camera.rays.device).reshape(-1))


def segment_centroid(depth, camera: CameraModel, min_depth=0.3,
                     max_depth=1.5, fg_mask=None):
    """Robust 3-D centroid of the foreground band → (centroid, n_pixels).

    Uses the median per coordinate, insensitive to background pixels
    leaking into the band. ``fg_mask`` (N,) bool optionally restricts
    the foreground (multi-object clustering).
    """
    z = _depth_on(depth, camera)
    mask = torch.isfinite(z) & (z > min_depth) & (z < max_depth)
    if fg_mask is not None:
        mask = mask & torch.as_tensor(fg_mask, device=z.device).reshape(-1)
    pts = camera.rays * z[:, None]
    masked = torch.where(mask[:, None], pts, float("nan"))
    return nanmedian(masked, 0), torch.sum(mask)


def _render(mesh: TriangleMesh, camera: CameraModel, poses,
            clip: bool = False):
    """Depth of ``mesh`` at each of ``poses`` (C, 7) → (C, N). The
    triangle chunk is degraded to the candidate batch
    (ops/budget.xla_tri_chunk): the refine generations score beams ×
    particles ≈ 2k poses at once, and the raycaster's (batch, N, chunk)
    intermediate has to fit.

    ``clip``: raycast only the pixels whose rays meet a pose's bounding
    sphere (every other pixel is a miss for every pose: the mesh lies in
    that sphere), the same depths for a fraction of the work when the
    object covers a small part of the frame."""
    if not clip:
        return raycast_depth(mesh, poses, camera.rays,
                             xla_tri_chunk(poses.shape[0],
                                           camera.num_pixels))
    # squared distance of each pose's origin to each pixel's ray line
    radius = torch.linalg.norm(mesh.vertices, dim=-1).max()
    t = poses[:, :3]
    unit = camera.rays / torch.linalg.norm(camera.rays, dim=-1,
                                           keepdim=True)
    along = t @ unit.T                                          # (C, N)
    off2 = torch.sum(t * t, dim=-1, keepdim=True) - along * along
    near = (off2 <= (1.001 * radius + 1e-4) ** 2) & (along > -radius)
    px = torch.nonzero(torch.any(near, dim=0)).reshape(-1)
    depth = torch.full((poses.shape[0], camera.num_pixels), MISS_DEPTH,
                       device=poses.device)
    if px.numel():
        depth[:, px] = raycast_depth(
            mesh, poses, camera.rays[px],
            xla_tri_chunk(poses.shape[0], int(px.numel())))
    return depth


def score_poses(poses, z, mesh: TriangleMesh, camera: CameraModel,
                bp: beam_mod.BeamParams, op: occ_mod.OcclusionParams,
                scene_depth=None, clip: bool = False):
    """Beam-model image log-likelihood of each candidate pose (C, 7)
    against the preprocessed frame ``z`` (N,) → (C,). ``scene_depth``
    ((N,) or one row per candidate, (C, N)) is a render of objects
    already placed: candidates are scored min-combined with it. ``clip``
    as in :func:`_render`."""
    depth_pred = _render(mesh, camera, poses, clip)
    if scene_depth is not None:
        depth_pred = torch.minimum(depth_pred, scene_depth)
    occ0 = op.initial_occlusion_prob.expand(poses.shape[0],
                                            camera.num_pixels)
    ll, _ = image_loglik(depth_pred, z, occ0, bp, op, 1.0)
    return ll


def align_poses(poses, z, fg, mesh: TriangleMesh, camera: CameraModel,
                scene_depth=None, clip: bool = False):
    """Analytic position alignment of each candidate pose (C, 7) to the
    foreground ``fg`` (N,) of the frame ``z`` (N,) → (C, 7), the
    orientation kept.

    The position moves by the robust depth offset (median of observed −
    predicted over the overlap) and by the silhouette-centroid shift in
    the tangent plane. With ``scene_depth`` ((N,) or (C, N)) only pixels
    where the candidate is in front of the placed objects count. ``clip``
    as in :func:`_render`."""
    n_fg = torch.clamp_min(torch.sum(fg).to(torch.float32), 1.0)
    obs_cx = torch.sum(torch.where(fg, camera.rays[:, 0], 0.0)) / n_fg
    obs_cy = torch.sum(torch.where(fg, camera.rays[:, 1], 0.0)) / n_fg
    pred = _render(mesh, camera, poses, clip)                  # (C, N)
    on = torch.isfinite(pred)
    if scene_depth is not None:
        # only trust pixels where the candidate is actually visible
        on = on & (pred <= scene_depth + 0.01)
    both = on & fg[None, :]
    dz = torch.where(both, z[None, :] - pred, float("nan"))
    dz = torch.nan_to_num(nanmedian(dz, -1))                   # (C,)
    non = torch.clamp_min(torch.sum(on, dim=-1).to(torch.float32), 1.0)
    pcx = torch.sum(torch.where(on, camera.rays[None, :, 0], 0.0),
                    dim=-1) / non
    pcy = torch.sum(torch.where(on, camera.rays[None, :, 1], 0.0),
                    dim=-1) / non
    depth0 = poses[:, 2]
    shift = torch.stack([(obs_cx - pcx) * depth0,
                         (obs_cy - pcy) * depth0, dz], dim=-1)
    return torch.cat([poses[:, :3] + shift, poses[:, 3:]], dim=-1)


def _best_of(cands, ll_c):
    """Per beam, the best of its candidates (M, C, 7) / (M, C)."""
    best = torch.argmax(ll_c, dim=1)
    rows = torch.arange(cands.shape[0], device=cands.device)
    return cands[rows, best], ll_c[rows, best]


def polish_poses(beams, beam_ll, z, fg, mesh: TriangleMesh,
                 camera: CameraModel, bp: beam_mod.BeamParams,
                 op: occ_mod.OcclusionParams, rounds: int,
                 scene_depth=None, clip: bool = False):
    """``rounds`` of deterministic rotation coordinate descent with the
    analytic position alignment → (beams (M, 7), their scores (M,)).

    Each round aligns every beam, then line-searches each rotation axis
    over ``POLISH_OFFSETS`` and keeps the best offset (0 included).
    ``scene_depth`` is (N,) or one row per beam (M, N); ``clip`` as in
    :func:`_render`."""
    dev = beams.device
    offsets = torch.tensor(POLISH_OFFSETS, device=dev)
    n_off = offsets.shape[0]
    cand_scene = scene_depth
    if scene_depth is not None and scene_depth.ndim == 2:
        cand_scene = scene_depth.repeat_interleave(n_off, dim=0)
    for _ in range(rounds):
        beams = align_poses(beams, z, fg, mesh, camera, scene_depth, clip)
        m = beams.shape[0]
        for ax in range(3):
            dr = torch.zeros((n_off, 3), device=dev)
            dr[:, ax] = offsets
            q = se3.quat_boxplus(
                beams[:, None, 3:7].expand(m, n_off, 4),
                dr[None].expand(m, n_off, 3))
            cands = torch.cat([beams[:, None, :3].expand(m, n_off, 3), q],
                              dim=-1)
            ll_c = score_poses(cands.reshape(-1, 7), z, mesh, camera, bp,
                               op, cand_scene, clip).reshape(m, n_off)
            beams, beam_ll = _best_of(cands, ll_c)
    return beams, beam_ll


def find_initial_pose(depth, mesh: TriangleMesh, camera: CameraModel,
                      bp: beam_mod.BeamParams = None,
                      op: occ_mod.OcclusionParams = None,
                      min_depth=0.3, max_depth=1.5,
                      n_axes: int = 12, n_spins: int = 4,
                      depth_offsets=(0.0, 0.03, 0.06),
                      refine_particles: int = 256,
                      refine_steps: int = 4, polish_rounds: int = 3,
                      generator=None, draws=None,
                      return_beams: bool = False,
                      fg_mask=None, scene_depth=None):
    """Search for the object pose in one frame → (pose (7,), score, n_fg).

    The returned pose is in the *centred-mesh* frame (what the filters
    use); :func:`initialize_tracker` handles the model-frame conversion.

    Random numbers: refine step ``s`` perturbs each beam by standard
    normals of shape (beams, refine_particles, 3) for position and for
    rotation, taken from ``draws[s] = (n_pos, n_rot)`` when given, else
    drawn from ``generator`` (default: a generator seeded with 0).

    Multi-object hooks (used by :func:`find_initial_poses`):
      * ``fg_mask`` (N,) bool restricts the foreground used for the
        centroid seed and silhouette alignment to one object's pixel
        cluster (scoring stays full-frame, constant across candidates);
      * ``scene_depth`` (N,) is a depth render of already-placed objects:
        candidates are scored min-combined with it (explaining-away: a
        candidate hidden behind a placed object is not rewarded), and
        alignment only trusts pixels where the candidate is in front.
    """
    dev = camera.rays.device
    mesh = mesh.to(dev)
    bp = bp or beam_mod.make_beam_params(device=dev)
    op = op or occ_mod.make_occlusion_params(device=dev)
    if generator is None and draws is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    z = _depth_on(depth, camera)
    fg = torch.isfinite(z) & (z > min_depth) & (z < max_depth)
    if fg_mask is not None:
        fg = fg & torch.as_tensor(fg_mask, device=dev).reshape(-1)
    centroid, n_fg = segment_centroid(z, camera, min_depth, max_depth,
                                      fg_mask=fg_mask)

    quats = orientation_candidates(n_axes, n_spins, device=dev)  # (Q, 4)
    view = centroid / torch.clamp_min(torch.linalg.norm(centroid), 1e-6)
    seed = centroid + float(depth_offsets[1] if len(depth_offsets) > 1
                            else 0.03) * view
    poses = torch.cat([seed.expand(quats.shape[0], 3), quats], dim=-1)

    def score(poses):
        return score_poses(poses, z, mesh, camera, bp, op, scene_depth)

    def align(poses):
        return align_poses(poses, z, fg, mesh, camera, scene_depth)

    # Analytic position alignment per candidate before ranking: the
    # centroid seed is biased (median of the *visible* surface is not the
    # object centre), and a few cm of position error corrupts the coarse
    # scores enough to bury the true orientation. Twice.
    poses = align(align(poses))
    ll = score(poses)

    # Orientation-diverse beam selection: greedily take the best-scoring
    # candidates whose orientation differs from everything already taken
    # (otherwise one attractive wrong basin fills the whole beam and the
    # true basin never gets refined). Carrying several orientations
    # through the local search matters because the coarse scores are
    # distorted by the position seed's error.
    order = torch.argsort(-ll, stable=True)
    sorted_poses, sorted_ll = poses[order], ll[order]
    sorted_q = sorted_poses[:, 3:7]
    suppressed = torch.zeros((sorted_q.shape[0],), dtype=torch.bool,
                             device=dev)
    picks = []
    for _ in range(BEAM):
        idx = torch.argmax((~suppressed).to(torch.int8))  # best unsuppressed
        picks.append(idx)
        qdot = torch.abs(torch.sum(sorted_q * sorted_q[idx][None, :],
                                   dim=-1))
        suppressed = suppressed | (qdot > 0.93)           # within ~42°
        suppressed[idx] = True
    picks = torch.stack(picks)
    beams, beam_ll = sorted_poses[picks], sorted_ll[picks]    # (M, 7), (M,)
    m = beams.shape[0]

    for step in range(refine_steps):
        # Re-run the analytic position alignment every generation: with a
        # ~5 mm beam sigma the correct basin is a needle in 6-DoF, and
        # random search alone lands the broad (symmetric-flip) basins
        # first. Aligning each beam's position analytically reduces the
        # search to orientation.
        beams = align(beams)
        # Wide first generation (a coarse-grid winner can sit ~40° from
        # its basin optimum), annealed geometrically down to a fixed fine
        # scale (~0.03 rad / 3 mm) whatever the step count.
        frac = step / max(refine_steps - 1, 1)
        rot_s = 0.55 * (0.03 / 0.55) ** frac
        pos_s = 0.02 * (0.003 / 0.02) ** frac
        if draws is not None:
            n_pos, n_rot = (
                d.to(dev, torch.float32) if isinstance(d, torch.Tensor)
                else torch.tensor(np.asarray(d, np.float32), device=dev)
                for d in draws[step])
        else:
            n_pos = torch.randn((m, refine_particles, 3),
                                generator=generator, device=dev)
            n_rot = torch.randn((m, refine_particles, 3),
                                generator=generator, device=dev)
        cands = torch.cat([
            beams[:, None, :3] + pos_s * n_pos,
            se3.quat_boxplus(
                beams[:, None, 3:7].expand(m, refine_particles, 4),
                rot_s * n_rot)], dim=-1)
        cands = torch.cat([beams[:, None], cands], dim=1)
        ll_c = score(cands.reshape(-1, 7)).reshape(m, -1)
        beams, beam_ll = _best_of(cands, ll_c)

    # Polish: the anneal ladder locks basins but leaves beams up to ~0.15
    # rad under their optima, enough for a broad wrong basin (a
    # near-symmetric flip) to outrank a narrow correct one. A per-axis
    # line search walks likelihood ridges directly.
    beams, beam_ll = polish_poses(beams, beam_ll, z, fg, mesh, camera, bp,
                                  op, polish_rounds, scene_depth)

    best = torch.argmax(beam_ll)
    if return_beams:
        return beams[best], beam_ll[best], int(n_fg), beams, beam_ll
    return beams[best], beam_ll[best], int(n_fg)


def _cluster_masks(z, camera: CameraModel, n_clusters: int,
                   min_depth, max_depth, iters: int = 12, centers=None):
    """Partition foreground pixels into ``n_clusters`` 3-D k-means
    clusters (host-side NumPy, init-time only) → list of (N,) bool masks
    on the camera's device.

    Seeded by spreading centres along the principal axis of the
    foreground point cloud, which separates side-by-side objects and
    front/behind mutual-occlusion configurations (depth is a coordinate),
    or from ``centers`` (n_clusters, 3) when given (a re-anchor's
    objects, so that cluster k is object k's).
    """
    dev = camera.rays.device
    zn = torch.as_tensor(z).detach().cpu().numpy().astype(
        np.float64).reshape(-1)
    fg = np.isfinite(zn) & (zn > min_depth) & (zn < max_depth)
    idx = np.where(fg)[0]
    masks_all = [np.zeros(zn.shape[0], bool) for _ in range(n_clusters)]

    def out():
        return [torch.as_tensor(m, device=dev) for m in masks_all]

    if idx.size < 2 * n_clusters:
        for m in masks_all:
            m[idx] = True
        return out()
    p = camera.rays.detach().cpu().numpy().astype(
        np.float64)[idx] * zn[idx, None]
    if centers is None:
        c0 = p.mean(0)
        d = p - c0
        ax = np.linalg.svd(d, full_matrices=False)[2][0]
        t = d @ ax
        qs = np.quantile(t, (np.arange(n_clusters) + 0.5) / n_clusters)
        centers = c0 + qs[:, None] * ax
    else:
        centers = torch.as_tensor(centers).detach().cpu().numpy().astype(
            np.float64).reshape(n_clusters, 3)
    lab = np.zeros(idx.size, np.int64)
    for _ in range(iters):
        dist = ((p[:, None] - centers[None]) ** 2).sum(-1)
        lab = dist.argmin(1)
        for k in range(n_clusters):
            sel = lab == k
            if sel.any():
                centers[k] = p[sel].mean(0)
            else:
                # a cluster that lost all members is re-seeded from the
                # largest cluster's farthest point
                big = int(np.bincount(lab, minlength=n_clusters).argmax())
                pb = p[lab == big]
                centers[k] = pb[int(np.argmax(
                    ((pb - centers[big]) ** 2).sum(-1)))]
    # final assignment against the (possibly re-seeded) centres
    lab = ((p[:, None] - centers[None]) ** 2).sum(-1).argmin(1)
    for k in range(n_clusters):
        sel = lab == k
        if sel.any():
            masks_all[k][idx[sel]] = True
        else:
            masks_all[k][idx] = True     # NaN-safe fallback
    return out()


def find_initial_poses(depth, meshes, camera: CameraModel,
                       bp: beam_mod.BeamParams = None,
                       op: occ_mod.OcclusionParams = None,
                       min_depth=0.3, max_depth=1.5, generator=None,
                       **kwargs):
    """Joint K-object auto-init → (poses (K, 7) centred frame, scores).

    The K ≥ 2 generalization of :func:`find_initial_pose`: partition the
    foreground into K 3-D clusters, then greedily assign (object mesh,
    cluster) pairs best-score-first; each placed object is rendered into
    a scene-depth buffer so later searches score candidates with
    explaining-away and later alignments ignore hidden pixels. All
    searches draw from the one ``generator``.
    """
    dev = camera.rays.device
    meshes = [m.to(dev) for m in meshes]
    num_objects = len(meshes)
    z = _depth_on(depth, camera)
    if generator is None and kwargs.get("draws") is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return_beams = bool(kwargs.pop("return_beams", False))
    if num_objects == 1:
        pose, score, _, beams, beam_ll = find_initial_pose(
            z, meshes[0], camera, bp=bp, op=op, min_depth=min_depth,
            max_depth=max_depth, generator=generator, return_beams=True,
            **kwargs)
        if return_beams:
            return pose[None], score[None], [(beams, beam_ll)]
        return pose[None], score[None]

    masks = _cluster_masks(z, camera, num_objects, min_depth, max_depth)
    scene = None
    placed = [None] * num_objects
    scores = [None] * num_objects
    obj_beams = [None] * num_objects
    remaining_obj = list(range(num_objects))
    remaining_clu = list(range(num_objects))
    while remaining_obj:
        best = None
        for o in remaining_obj:
            for c in remaining_clu:
                pose, sc, _, beams, beam_ll = find_initial_pose(
                    z, meshes[o], camera, bp=bp, op=op,
                    min_depth=min_depth, max_depth=max_depth,
                    generator=generator, fg_mask=masks[c],
                    scene_depth=scene, return_beams=True, **kwargs)
                sc_f = float(sc)
                if np.isnan(sc_f):
                    continue            # degenerate search (empty fg)
                if best is None or sc_f > float(best[0]):
                    best = (sc, o, c, pose, beams, beam_ll)
        if best is None:
            raise ValueError(
                "multi-object init failed: no finite candidate score "
                "(empty/degenerate foreground?)")
        sc, o, c, pose, beams, beam_ll = best
        placed[o], scores[o], obj_beams[o] = pose, sc, (beams, beam_ll)
        remaining_obj.remove(o)
        remaining_clu.remove(c)
        pred = raycast_depth(meshes[o], pose, camera.rays)
        scene = pred if scene is None else torch.minimum(scene, pred)
    if return_beams:
        return torch.stack(placed), torch.stack(scores), obj_beams
    return torch.stack(placed), torch.stack(scores)


def _tracker_init_kwargs(tracker, depth, reuse_background,
                         keep_covariance=False):
    """Optional arguments of ``tracker.initialize`` that only some
    trackers take (a learned background model's ``first_frame`` and
    ``reuse_background``, a Gaussian belief's ``keep_covariance``); the
    particle tracker takes none."""
    params = inspect.signature(tracker.initialize).parameters
    kw = {}
    if "first_frame" in params:
        kw["first_frame"] = depth
    if reuse_background and "reuse_background" in params:
        kw["reuse_background"] = True
    if keep_covariance and "keep_covariance" in params:
        kw["keep_covariance"] = True
    return kw


def _temperature(tracker, hypothesis_margin):
    """Logit temperature of the kept hypotheses: the margin edge maps to
    ~1/P of the mass (P the tracker's particle count, 1000 for a tracker
    without one)."""
    n_part = int(getattr(getattr(tracker, "config", None),
                         "evaluation_count", 1000))
    return hypothesis_margin / float(np.log(max(n_part, 2)))


def initialize_tracker(tracker, depth, hypothesis_margin: float = 30.0,
                       min_hypotheses: int = 1,
                       reuse_background: bool = False, **kwargs):
    """Auto-initialize a tracker from one frame → (pose(s) in the model
    frame, score).

    Every refined beam pose within ``hypothesis_margin`` nats of the
    winner is kept as an init *hypothesis*: near-symmetric twins the
    one-shot search cannot distinguish race as island beliefs over the
    next frames (``ParticleTracker.initialize``). A clear winner leaves
    a single hypothesis, reproducing the plain init exactly.

    ``min_hypotheses``: keep at least this many top beams per object even
    when the margin filter passes fewer (flip-aware recovery: a watchdog
    re-init passes 2, because a locked-in wrong basin can win the
    single-frame search argmax decisively).

    Temperature: raw scores are full-image log-likelihoods whose nat
    differences dwarf a softmax. The kept logits are rescaled so the
    margin edge maps to ~1/P mass, preserving the ranking.

    ``kwargs`` go to the search (``n_axes``, ``n_spins``,
    ``refine_particles``, ``refine_steps``, ``polish_rounds``,
    ``generator``, ...).
    """
    meshes = list(tracker.meshes)
    temp = _temperature(tracker, hypothesis_margin)
    hyp_kwargs = {}

    if len(meshes) > 1:
        # K-object scene: joint greedy search with explaining-away, then
        # per-object hypothesis beams combined as a product space through
        # the single hypothesis API (the near-symmetric-flip failure mode
        # is per object).
        poses_center, scores, obj_beams = find_initial_poses(
            depth, meshes, tracker.camera, bp=tracker.beam_params,
            return_beams=True, **kwargs)
        centers = torch.stack([m.center for m in meshes])
        poses_model = base.to_model_frame(poses_center, centers)
        per_obj = []
        for o, (beams, beam_ll) in enumerate(obj_beams):
            ll = beam_ll.detach().cpu().numpy()
            order = np.argsort(-ll, kind="stable")
            kept = [int(i) for i in order
                    if ll[i] >= ll.max() - hypothesis_margin][:4]
            if len(kept) < min_hypotheses:
                kept = [int(i) for i in
                        order[:min(min_hypotheses, order.size)]]
            pm = base.to_model_frame(beams[kept], centers[o])
            per_obj.append((pm, ll[kept] - ll.max()))
        if any(p[0].shape[0] > 1 for p in per_obj):
            combos = sorted(
                itertools.product(*[range(p[0].shape[0])
                                    for p in per_obj]),
                key=lambda c: -sum(per_obj[o][1][i]
                                   for o, i in enumerate(c)))[:32]
            hyp = torch.stack([
                torch.stack([per_obj[o][0][i]
                             for o, i in enumerate(combo)])
                for combo in combos])                    # (H, K, 7)
            logits = np.array([sum(per_obj[o][1][i]
                                   for o, i in enumerate(combo))
                               for combo in combos], np.float32)
            hyp_kwargs = dict(hypotheses=hyp,
                              hypothesis_logits=logits / temp)
        hyp_kwargs.update(_tracker_init_kwargs(tracker, depth,
                                               reuse_background))
        tracker.initialize(poses_model, **hyp_kwargs)
        return poses_model, float(torch.sum(scores))

    mesh = meshes[0]
    pose_center, score, n_fg, beams, beam_ll = find_initial_pose(
        depth, mesh, tracker.camera, bp=tracker.beam_params,
        return_beams=True, **kwargs)
    pose_model = base.to_model_frame(pose_center, mesh.center)
    keep = beam_ll >= beam_ll.max() - hypothesis_margin
    if int(keep.sum()) < min_hypotheses:
        order = torch.argsort(-beam_ll, stable=True)
        keep = torch.zeros_like(keep)
        keep[order[:min_hypotheses]] = True
    if int(keep.sum()) > 1:
        hyp_kwargs = dict(
            hypotheses=base.to_model_frame(beams[keep], mesh.center),
            hypothesis_logits=(beam_ll[keep] - beam_ll.max()) / temp)
    hyp_kwargs.update(_tracker_init_kwargs(tracker, depth,
                                           reuse_background))
    tracker.initialize(pose_model, **hyp_kwargs)
    return pose_model, score


def reanchor_tracker(tracker, depth, min_depth=0.3, max_depth=1.5,
                     polish_rounds: int = 3,
                     hypothesis_margin: float = 30.0, **search_kwargs):
    """Re-anchor a tracker's belief on the frame ``depth`` after a long
    frame gap (``runtime.node.run``) → (before, after), the published
    model-frame poses (K, 7) as they were and as placed, or None when the
    frame has no foreground pixel in the depth band (nothing changes).

    The search's deterministic local stage, seeded from what the tracker
    holds (``tracker.hypothesis_means()``: each racing hypothesis in a
    trial, else the belief's mean): the analytic alignment twice, then
    ``polish_rounds`` rounds of :func:`polish_poses`. No coarse grid, no
    random refinement: it takes no draws; its renders are clipped to the
    pixels in the objects' reach (:func:`_render`). K objects are
    re-anchored one by one, each on its own cluster of the foreground
    (k-means seeded from the objects' positions) with the others' render
    as ``scene_depth``. The tracker is then re-initialized at the best
    hypothesis; two or more race again as a trial, with their logits
    re-scored on this frame under :func:`initialize_tracker`'s
    temperature rule; a learned background map is kept, and so is a
    Gaussian belief's covariance (its initial spread over the stale map
    throws the first step several mm off).

    ``search_kwargs``: the search's other arguments (``n_axes``,
    ``refine_particles``, ...), which the re-anchor does not use.
    """
    camera = tracker.camera
    meshes = list(tracker.meshes)
    centers = tracker.centers
    before = tracker.hypothesis_means()                 # (H, K, 7)
    poses = base.to_center_frame(before, centers)
    z = _depth_on(depth, camera)
    fg = torch.isfinite(z) & (z > min_depth) & (z < max_depth)
    masks = [fg] if len(meshes) == 1 else _cluster_masks(
        z, camera, len(meshes), min_depth, max_depth,
        centers=poses[0, :, :3])
    if not all(bool(m.any()) for m in masks):
        return None
    bp = tracker.beam_params
    op = occ_mod.make_occlusion_params(device=camera.rays.device)
    for k, mesh in enumerate(meshes):
        scene = None
        for j, other in enumerate(meshes):
            if j != k:
                d = _render(other, camera, poses[:, j], clip=True)
                scene = d if scene is None else torch.minimum(scene, d)
        beams = poses[:, k]
        for _ in range(2):
            beams = align_poses(beams, z, masks[k], mesh, camera, scene,
                                clip=True)
        ll = score_poses(beams, z, mesh, camera, bp, op, scene, clip=True)
        beams, ll = polish_poses(beams, ll, z, masks[k], mesh, camera, bp,
                                 op, polish_rounds, scene, clip=True)
        poses[:, k] = beams
    # the last object was scored against the others' placed render: its
    # scores are the hypotheses' joint scores
    after = base.to_model_frame(poses, centers)
    best = int(torch.argmax(ll))
    kwargs = _tracker_init_kwargs(tracker, depth, reuse_background=True,
                                  keep_covariance=True)
    if after.shape[0] > 1:
        kwargs.update(hypotheses=after, hypothesis_logits=(
            ll - ll.max()) / _temperature(tracker, hypothesis_margin))
    tracker.initialize(after[best], **kwargs)
    return before[0], after[best]
