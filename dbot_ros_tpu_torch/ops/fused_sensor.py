"""The fused sensor: candidate pass → constant packing → compaction ladder
→ pixel-row gather → fused likelihood kernel → pixel-row scatter.

Port of the host side of ``dbot_ros_tpu/ops/raycast_pallas.py``
(``pack_matrix``, ``pose_features``, ``pack_constants``,
``fused_loglik_packed``, ``make_params_vec``, ``FusedSensor``,
``make_fused_sensor``). The kernels themselves are in ops/kernels.py.

Occlusion layout: the map is pixel-major, ``(n_pad, p_pad)`` row-major,
with ``n_pad = round_up(N, nb)`` and ``p_pad = round_up(P, 128)``. A
pixel's particles are one contiguous row, so kernel access is coalesced
and the compaction path's gather and scatter are row copies. (The JAX
package's ``(n_pad·pr, 128)`` kernel layout is a reshape of the same
matrix with ``p_pad`` further rounded to 1024-lane multiples;
``interop.occlusion_from_jax`` converts.) Slabs are ``(T, 10, p_pad)``
float32: the 10 constants of one triangle, particles minor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from dbot_ros_tpu_torch.models.beam import BeamParams
from dbot_ros_tpu_torch.models.occlusion import OcclusionParams
from dbot_ros_tpu_torch.models.transition import as_dt
from dbot_ros_tpu_torch.ops import kernels
from dbot_ros_tpu_torch.utils import se3
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh
from dbot_ros_tpu_torch.utils.profiling import span

_TINY = 1e-30
LANES = 128
# the reference's lineage-gather mode names; all select kernels.lineage_gather
LINEAGE_MODES = ("grouped", "windowed", "take", "pallas")


def _round_up(x, m):
    return (x + m - 1) // m * m


def particle_pad(num_particles: int) -> int:
    """Padded particle count of the occlusion map and slabs."""
    return _round_up(max(num_particles, 1), LANES)


# ---------------------------------------------------------------------------
# Packing the per-particle constants into per-triangle slabs
# ---------------------------------------------------------------------------

def _levi_civita():
    eps = np.zeros((3, 3, 3), np.float32)
    for (i, j, k), s in (((0, 1, 2), 1.0), ((1, 2, 0), 1.0),
                         ((2, 0, 1), 1.0), ((0, 2, 1), -1.0),
                         ((2, 1, 0), -1.0), ((1, 0, 2), -1.0)):
        eps[i, j, k] = s
    return eps


def pack_matrix(mesh: TriangleMesh):
    """Static coefficient tensor M (T, 10, 37) of the pack product.

    Every transformed Möller–Trumbore constant is linear in the 37-dim
    pose feature F = [1 | vec(R) (9) | vec(τ ⊗ R) (27)]:

        g_u'   = R g_u + τ × (R e2)      g_det' = R g_det
        g_v'   = R g_v − τ × (R e1)      t_num' = t_num + τ · (R g_det)

    Feature indexing: f=0 constant; f=1+3i+j ↦ R[i,j];
    f=10+9a+3b+l ↦ τ[a]·R[b,l]. Entries are mesh constants times 0/±1,
    so building it in numpy float32 is exact. Build once per mesh.
    """
    T = mesh.padded_triangles
    eye = np.eye(3, dtype=np.float32)
    eps = _levi_civita()

    def arr(x):
        return x.detach().cpu().numpy().astype(np.float32)

    def rot_block(g):  # coeff of output comp i on R[i,j]: g[t, j]
        return np.einsum("ik,tj->tikj", eye, g).reshape(T, 3, 9)

    def cross_block(e):  # coeff of (τ × (R e))_i on τ[a]R[b,l]: ε_iab e[t,l]
        return np.einsum("iab,tl->tiabl", eps, e).reshape(T, 3, 27)

    M = np.zeros((T, 10, 37), np.float32)
    M[:, 0:3, 1:10] = rot_block(arr(mesh.g_u))
    M[:, 0:3, 10:37] = cross_block(arr(mesh.tri_e2))
    M[:, 3:6, 1:10] = rot_block(arr(mesh.g_v))
    M[:, 3:6, 10:37] = -cross_block(arr(mesh.tri_e1))
    M[:, 6:9, 1:10] = rot_block(arr(mesh.g_det))
    M[:, 9, 0] = arr(mesh.t_num)
    # τ·(R g_det) = Σ τ[a] R[a,l] g_det[t,l]  → features with b == a
    M[:, 9, 10:37] = np.einsum("ab,tl->tabl", eye,
                               arr(mesh.g_det)).reshape(T, 27)
    return torch.from_numpy(M).to(mesh.g_u.device)


def pose_features(poses, p_pad: int):
    """poses (P, 7) → pose-feature matrix F (37, p_pad); padding
    particles have all-zero features (→ zero constants → miss)."""
    P = poses.shape[0]
    R = se3.quat_to_matrix(se3.pose_quat(poses))          # (P, 3, 3)
    tau = se3.pose_trans(poses)                           # (P, 3)
    F = torch.cat([
        torch.ones((P, 1), dtype=torch.float32, device=poses.device),
        R.reshape(P, 9),
        (tau[:, :, None, None] * R[:, None, :, :]).reshape(P, 27),
    ], dim=1)                                             # (P, 37)
    if p_pad != P:
        F = torch.cat([F, F.new_zeros((p_pad - P, 37))], dim=0)
    return F.T.contiguous()                               # (37, p_pad)


def pack_constants(mesh: TriangleMesh, poses, p_pad: int, features=None,
                   M=None):
    """poses (P, 7) → (T, 10, p_pad) slabs, rows
    [g_u(3) | g_v(3) | g_det(3) | t_num]; padding particles are zero.

    One float32 product (10T, 37) @ (37, p_pad) (TF32 off: PyTorch's
    default). Pass ``M = pack_matrix(mesh)`` on hot paths.
    """
    T = mesh.padded_triangles
    if features is None:
        features = pose_features(poses, p_pad)
    if M is None:
        M = pack_matrix(mesh)
    return (M.reshape(T * 10, 37) @ features).reshape(T, 10, p_pad)


def make_params_vec(bp: BeamParams, op: OcclusionParams, dt_frames):
    """Model parameters + occlusion-chain coefficients as (16,) f32 on
    the parameters' device, with no copy from the host and no host read
    (so a CUDA graph can hold it): ``dt_frames`` is a number or a 0-d
    tensor on that device.

    The kernel ages the chain as ``sign(g)·exp(log|g|·(age + dt_frames))``;
    nonzero ages need g >= 0 (FusedSensor enables lazy aging only then).
    Entry 15 is the reference's slot for its one barycentric slack; the
    kernel reads a slack per triangle instead (``tri_slack``), and the
    slot stays 0.
    """
    g = op.p_occluded_occluded - op.p_occluded_visible
    pi = op.p_occluded_visible / torch.clamp_min(1.0 - g, 1e-12)
    # as_dt: a number or a 0-d tensor → a 0-d float32 tensor, no copy
    dt_frames = as_dt(dt_frames, g.device)
    gdt = torch.sign(g) * torch.pow(torch.abs(g), dt_frames)
    lg = torch.log(torch.clamp_min(torch.abs(g), 1e-30))
    return torch.stack([
        bp.model_sigma, bp.sigma_factor, bp.tail_weight, bp.min_depth,
        bp.max_depth, bp.exponential_rate, bp.p_invalid_occluded,
        bp.p_invalid_visible, bp.p_invalid_background, pi, gdt,
        1.0 / (bp.max_depth - bp.min_depth),
        lg, dt_frames, torch.sign(g), torch.zeros_like(g),
    ]).to(torch.float32)


def fused_loglik_packed(gt, occ, z_obs, cand, rays, params_vec,
                        num_particles: int, nb: int = 64, ages=None, *,
                        tri_slack):
    """Run the fused kernel on pre-packed slabs, as the reference does.

    Pixels are padded to ``n_pad = round_up(N, nb)`` with NaN depth and
    the degenerate last slab as candidate, so the loglik includes the
    reference's ``(n_pad − N)·log p_invalid_background`` constant.

    Args:
      gt: (T, 10, p_pad) slabs; occ: (n_pad, p_pad) map rows;
      z_obs: (N,); cand: (N, K) ids into ``gt``; rays: (N, 3);
      params_vec: (16,); ages: optional (N,) staleness (None = fresh);
      tri_slack: (T,) barycentric slack of each slab's triangle, required
        (the reference's one ``params_vec[15]`` is that number expanded
        to (T,)).
    Returns (loglik (P,), occ_post (n_pad, p_pad)).
    """
    N, K = cand.shape
    n_pad = _round_up(N, nb)
    if gt.shape[2] != occ.shape[1] or occ.shape[0] != n_pad:
        raise ValueError(
            f"occ must be ({n_pad}, {gt.shape[2]}), got {tuple(occ.shape)}")
    dev = occ.device
    cand = cand.to(torch.int32)
    ages = (torch.zeros((N,), dtype=torch.float32, device=dev)
            if ages is None else ages.to(torch.float32))
    pad = n_pad - N
    if pad:
        z_obs = torch.cat([z_obs, z_obs.new_full((pad,), float("nan"))])
        rays = torch.cat([rays, rays.new_zeros((pad, 3))])
        cand = torch.cat([cand, cand.new_full((pad, K), gt.shape[0] - 1)])
        ages = torch.cat([ages, ages.new_zeros((pad,))])
    ll, occ_post = kernels.fused_loglik(
        gt, occ, z_obs.contiguous(), cand.contiguous(), rays.contiguous(),
        ages.contiguous(), params_vec,
        tri_slack.to(torch.float32).contiguous())
    return ll[:num_particles], occ_post


# ---------------------------------------------------------------------------
# Occlusion layout helpers
# ---------------------------------------------------------------------------

def occ_to_map(occ_pn, nb: int = 64):
    """(P, N) particle-major occlusion → the sensor's (n_pad, p_pad) map
    (padding zero)."""
    P, N = occ_pn.shape
    out = occ_pn.new_zeros((_round_up(N, nb), particle_pad(P)))
    out[:N, :P] = occ_pn.T
    return out


def occ_from_map(occ_m, num_pixels: int, num_particles: int):
    """Inverse of :func:`occ_to_map` → (P, N)."""
    return occ_m[:num_pixels, :num_particles].T


class FusedSensor:
    """RbSensor-contract sensor backed by the fused kernel.

    ``sensor(states (P, K, 13), occ, z_obs (N,), dt, commit=True) →
    (loglik (P,), occ')``. The occlusion leaf is the lazy ``(q, age)``
    tuple of :meth:`init_occlusion` (q the (n_pad, p_pad) map, age the
    (n_pad,) per-pixel staleness in frame units) when the chain has
    g = p_oo − p_ov >= 0, else the raw map.

    **In place:** with the lazy leaf and ``merge="scatter"`` (the
    default), the compacted levels scatter the selected pixels' rows into
    the *input* map ``q``, which is also returned; callers must not hold
    the old map. ``merge="select"`` instead gathers the posterior rows
    back to every pixel and selects them into a *new* map (the input map
    is left as it was). With ``commit=False`` (the non-final coordinate
    blocks of a multi-object step) the map is left untouched and the
    input leaf is returned, on every route.

    Compaction ladder (``levels``, tightest first, default
    ``[(1/12, 0.2), (0.5, 0.75)]``; ``active_cap_frac`` and
    ``tri_cap_frac`` define one level where ``levels`` is not given):
    pixels whose candidates are all the degenerate triangle are misses
    for every particle, so each level runs the kernel on at most ``pcap``
    selected pixels and ``tcap`` packed triangles and adds the rest back
    as a particle-independent constant. The level is picked by one host
    read of (n_active, n_uniq) per frame and recorded in ``last_level``
    (an index into :meth:`caps`; ``len(caps)`` is the full level). Exact
    at every level. A raw map (g < 0, or a raw leaf from the caller)
    takes the eager branch on a compacted level: the selected rows go
    through the kernel, the whole map is propagated in float32 and cast
    once, and the rows are written into that new map.

    Candidates come from one raycast per object at the *unweighted* mean
    of its particles, or with ``reference_poses=R > 1`` at the R
    index-strided particles ``(r·P)//R`` (one per block of a
    multi-hypothesis cloud, whose mean is a ghost pose), min-combined.
    The barycentric slack of the inside-test is ``bary_slack`` for every
    triangle when given (``0.0``: exact), else the automatic rule per
    object (ops/slack.py): ``bary_slack_px`` pixels of footprint at the
    mean depth of object ``k``'s particles, in units of mesh ``k``'s own
    median edge, for the triangles of mesh ``k``. (The reference
    measures every mesh in the finest mesh's units at the deepest
    object's depth; with one object the two rules agree.)

    ``lineage_gather`` takes the reference's four mode names; all select
    the port's one kernel (``kernels.lineage_gather``): they compute the
    same function, and only their TPU implementations differ.
    ``interpret`` names Pallas's interpreter, which has no counterpart
    here (a CPU tensor takes the kernels' plain versions): any value but
    None raises. ``device`` defaults to the camera's; meshes and
    parameters are moved there.
    """

    def __init__(self, meshes, camera, bp, op, frame_rate=30.0,
                 num_candidates=2, radius=2, nb=64, interpret=None,
                 active_cap_frac=None, tri_cap_frac=None, levels=None,
                 lineage_gather="take", bary_slack=None,
                 bary_slack_px=0.25, merge="scatter",
                 occ_dtype=torch.bfloat16, reference_poses=1, device=None):
        from dbot_ros_tpu_torch.ops import slack as slack_mod

        if interpret is not None:
            raise ValueError(
                f"interpret={interpret!r}: Pallas's interpreter has no "
                "counterpart in the port; a CPU tensor takes the kernels' "
                "plain PyTorch versions, a CUDA tensor the kernels")
        if lineage_gather not in LINEAGE_MODES:
            raise ValueError(f"unknown lineage_gather: {lineage_gather!r}")
        if merge not in ("scatter", "select"):
            raise ValueError(f"unknown merge mode: {merge!r}")
        self.lineage_gather = lineage_gather
        self.merge = merge
        self.device = torch.device(device if device is not None
                                   else camera.rays.device)
        meshes = [meshes] if isinstance(meshes, TriangleMesh) else meshes
        self.meshes = [m.to(self.device) for m in meshes]
        self.camera = camera.to(self.device)
        self.bp = _params_to(bp, self.device)
        self.op = _params_to(op, self.device)
        if levels is None:
            if active_cap_frac is not None or tri_cap_frac is not None:
                levels = [(1.0 if active_cap_frac is None
                           else active_cap_frac,
                           1.0 if tri_cap_frac is None else tri_cap_frac)]
            else:
                levels = [(1.0 / 12.0, 0.2), (0.5, 0.75)]
        self.levels = [(float(a), float(t)) for a, t in levels]
        self._pack_M = [pack_matrix(m) for m in self.meshes]
        K = len(self.meshes)
        blocks = []
        for k, Mk in enumerate(self._pack_M):
            b = Mk.new_zeros((Mk.shape[0], 10, 37 * K))
            b[:, :, 37 * k:37 * (k + 1)] = Mk
            blocks.append(b)
        self._pack_M_union = torch.cat(blocks, dim=0)     # (Tu, 10, 37K)
        self.frame_rate = frame_rate
        self.num_candidates = num_candidates
        self.radius = radius
        self.nb = nb
        self.reference_poses = int(reference_poses)
        self.bary_slack = None if bary_slack is None else float(bary_slack)
        self.bary_slack_px = float(bary_slack_px)
        self._median_edges = [slack_mod.median_edge([m])
                              for m in self.meshes]
        self._fx = float(self.camera.camera_matrix[0, 0])
        # a fixed slack is one number for every union triangle
        self._fixed_slack = None if bary_slack is None else torch.full(
            (self.union_triangles,), self.bary_slack, dtype=torch.float32,
            device=self.device)
        self.occ_dtype = occ_dtype
        g = float(self.op.p_occluded_occluded - self.op.p_occluded_visible)
        self._lazy = g >= 0.0
        self.last_level = None

    def _pads(self, num_particles):
        return (particle_pad(num_particles),
                _round_up(self.camera.num_pixels, self.nb))

    def init_occlusion(self, num_particles, initial_prob):
        """Fresh occlusion leaf: lazy (q, age) tuple (or raw q for g < 0)."""
        p_pad, n_pad = self._pads(num_particles)
        q = torch.full((n_pad, p_pad), float(initial_prob),
                       dtype=self.occ_dtype, device=self.device)
        if not self._lazy:
            return q
        return (q, torch.zeros((n_pad,), dtype=torch.float32,
                               device=self.device))

    @staticmethod
    def _unpack_occ(occ):
        if isinstance(occ, (tuple, list)):
            return occ[0], occ[1]
        return occ, None

    def particle_stride(self, num_particles: int) -> int:
        """Columns of one ``num_particles`` block: the index stride inside
        a :meth:`concat_occlusion` result and the ``num_in`` unit of a
        gather from one (the port's 128-column rounding)."""
        return particle_pad(num_particles)

    def gather_occlusion(self, occ, parent_idx, num_in=None):
        """Particle-lineage gather ``out[n, c] = q[n, idx[c]]`` on the map
        (resampling), through ``kernels.lineage_gather``. The output has
        ``particle_pad(len(parent_idx))`` columns; indices are clamped
        into the source. Ages are per pixel and do not move. The result
        is a new map; the input map is left as it was.

        ``num_in`` is the source's column count when it is not the
        sensor's own map of ``len(parent_idx)`` particles (the
        distributed exchanges' surplus buffers and concatenated blocks);
        it must equal ``q.shape[1]``. Output padding columns then take
        ``min(c, num_in - 1)``, as the reference's ``pad_idx``; without
        ``num_in`` they keep their own columns.
        """
        q, age = self._unpack_occ(occ)
        p_in = q.shape[1]
        if num_in is not None and int(num_in) != p_in:
            raise ValueError(f"num_in={num_in} but the source has {p_in} "
                             "columns")
        p = parent_idx.shape[0]
        pad = torch.arange(p, particle_pad(p), dtype=torch.int32,
                           device=q.device)
        idx = torch.cat([parent_idx.to(torch.int32), pad]).clamp_(0, p_in - 1)
        out = kernels.lineage_gather(q, idx)
        return out if age is None else (out, age)

    def concat_occlusion(self, blocks, num_each):
        """Concatenate maps of ``num_each`` particles each along the
        particle (column) axis; block ``s`` starts at column
        ``s * particle_stride(num_each)``. The ages are those of the first
        block, as in the reference: the blocks' ages must agree (the
        distributed exchanges first materialize the maps with
        :meth:`materialize_occlusion` on a frame where columns cross
        ranks, parallel/dist_filter.py)."""
        qs = [self._unpack_occ(b)[0] for b in blocks]
        stride = self.particle_stride(num_each)
        if any(q.shape[1] != stride for q in qs):
            raise ValueError(f"blocks must have {stride} columns, got "
                             f"{[q.shape[1] for q in qs]}")
        out = torch.cat(qs, dim=1)
        age = self._unpack_occ(blocks[0])[1]
        return out if age is None else (out, age)

    def where_occlusion(self, particle_mask, a, b):
        """Per-particle select between two maps: column ``p`` from ``a``
        where ``particle_mask[p]``, else from ``b``; padding columns take
        ``b``. The ages are those of ``a``, as in the reference: the two
        maps' ages must agree (see :meth:`concat_occlusion`)."""
        qa, age_a = self._unpack_occ(a)
        qb, _ = self._unpack_occ(b)
        m = torch.zeros((qa.shape[1],), dtype=torch.bool, device=qa.device)
        m[:particle_mask.shape[0]] = particle_mask
        out = torch.where(m[None, :], qa, qb)
        return out if age_a is None else (out, age_a)

    def _chain(self, age):
        """(geff, pi): the lazy closed form's factor of every pixel of
        ``age`` (1 where its age is 0) and the chain's stationary
        occlusion, float32 on the device."""
        g = self.op.p_occluded_occluded - self.op.p_occluded_visible
        pi = self.op.p_occluded_visible / torch.clamp_min(1.0 - g, 1e-12)
        geff = torch.exp(torch.log(torch.clamp_min(g, 1e-30)) * age)
        return geff, pi

    def occlusion_as_pn(self, occ, num_particles):
        """The occlusion state as (P, N) float32, materialized to 'now'
        (lazy ages applied via the closed-form propagation)."""
        q, age = self._unpack_occ(occ)
        q = q.to(torch.float32)
        if age is not None:
            q = kernels.age_pixel_rows_plain(q, *self._chain(age))
        return occ_from_map(q, self.camera.num_pixels, num_particles)

    def materialize_occlusion(self, occ, now):
        """The lazy leaf with its ages applied to the map where ``now`` (a
        0-d bool tensor on the map's device), in the map's dtype, and its
        ages zero; where not ``now`` (or for a raw map) the leaf's values
        as they were, bit for bit. Every value is :meth:`occlusion_as_pn`'s,
        rounded once to the map's dtype. One pass over the map
        (``kernels.age_pixel_rows``), new buffers, no host read: the
        distributed exchanges call it before columns cross ranks, so that
        a column never meets another rank's ages."""
        q, age = self._unpack_occ(occ)
        if age is None:
            return occ
        geff, pi = self._chain(torch.where(now, age, 0.0))
        return (kernels.age_pixel_rows(q, geff, pi),
                torch.where(now, 0.0, age))

    @property
    def union_triangles(self) -> int:
        return sum(m.padded_triangles for m in self.meshes)

    def reference_states(self, states, k):
        """The poses (R, 7) object ``k`` is raycast at in the candidate
        pass: the unweighted mean of its particles, or with
        ``reference_poses=R > 1`` particles ``(r·P)//R``, r = 0..R−1 (P
        the real particle count)."""
        R, P = self.reference_poses, states.shape[0]
        if R <= 1:
            return se3.states_mean(states[:, k])[None, :7]
        rows = torch.arange(R, device=states.device) * P // R
        return states[rows, k, :7]

    def candidates(self, states):
        """Reference pass → per-pixel global candidate triangle ids (N, K).

        Each object is raycast at each of its :meth:`reference_states`;
        depths are min-combined in that order (a strictly nearer hit
        wins, the earlier image keeps ties) into a union id image, which
        is dilated; misses map to the union's degenerate last row.
        """
        from dbot_ros_tpu_torch.ops import deferred

        z_best = ids_best = None
        offset = 0
        for k, mesh in enumerate(self.meshes):
            for ref in self.reference_states(states, k):
                z_k, ids_k = deferred.raycast_ids(mesh, ref,
                                                  self.camera.rays)
                ids_k = torch.where(ids_k >= 0, ids_k + offset, -1)
                if z_best is None:
                    z_best, ids_best = z_k, ids_k
                else:
                    closer = z_k < z_best
                    z_best = torch.where(closer, z_k, z_best)
                    ids_best = torch.where(closer, ids_k, ids_best)
            offset += mesh.padded_triangles
        cand = deferred.candidate_ids(ids_best, self.camera.height,
                                      self.camera.width, self.radius,
                                      self.num_candidates)
        return torch.where(cand >= 0, cand, self.union_triangles - 1)

    def _active_cap(self, num_pixels: int, frac: float):
        """Kernel-pixel budget of one level (None = no pixel compaction)."""
        if frac >= 1.0:
            return None
        cap = _round_up(int(math.ceil(num_pixels * frac)), self.nb)
        return None if cap >= num_pixels else cap

    def _tri_cap(self, frac: float):
        """Packed-triangle budget of one level (None = pack all)."""
        if frac >= 1.0:
            return None
        cap = _round_up(int(math.ceil(self.union_triangles * frac)), 8)
        return None if cap >= self.union_triangles else cap

    def caps(self, num_pixels: int):
        """The ladder's (pcap, tcap) per level, tightest first; a level
        that compacts nothing ends the ladder (it is the full kernel)."""
        caps = []
        for pf, tf in self.levels:
            pcap, tcap = self._active_cap(num_pixels, pf), self._tri_cap(tf)
            if pcap is None and tcap is None:
                break
            caps.append((pcap, tcap))
        return caps

    def pack_full(self, states, p_pad):
        return torch.cat(
            [pack_constants(mesh, states[:, k, :7], p_pad,
                            M=self._pack_M[k])
             for k, mesh in enumerate(self.meshes)], dim=0)

    def pack_selected(self, states, p_pad, uniq):
        """Pack only the ``uniq`` triangle slots: one (10·tcap, 37K) @
        (37K, p_pad) product over the objects' feature blocks."""
        K = len(self.meshes)
        tcap = uniq.shape[0]
        M_sel = self._pack_M_union[uniq].reshape(tcap * 10, 37 * K)
        F_all = torch.cat([pose_features(states[:, k, :7], p_pad)
                           for k in range(K)], dim=0)     # (37K, p_pad)
        return (M_sel @ F_all).reshape(tcap, 10, p_pad)

    def selection(self, cand):
        """Compaction bookkeeping of one frame, all on the device.

        Returns a dict: ``slot`` (N,) selection rank of every pixel
        (actives first in index order, then inactives), ``ca``/``ci``
        cumulative active/inactive counts, ``n_active``; ``cp`` cumulative
        presence over the union triangles, ``n_uniq``; ``counts`` the two
        counts as one float32 pair (what :meth:`choose_level` reads).
        """
        deg = self.union_triangles - 1
        active = torch.any(cand != deg, dim=1)
        af = active.to(torch.float32)
        ca = torch.cumsum(af, 0)
        ci = torch.cumsum(1.0 - af, 0)
        n_active = ca[-1]
        slot = torch.where(active, ca - 1.0,
                           n_active + ci - 1.0).to(torch.int64)
        pres = torch.zeros((self.union_triangles,), dtype=torch.bool,
                           device=cand.device)
        pres.index_fill_(0, cand.reshape(-1), True)
        cp = torch.cumsum(pres.to(torch.float32), 0)
        return dict(slot=slot, ca=ca, ci=ci, n_active=n_active, cp=cp,
                    n_uniq=cp[-1], counts=torch.stack([n_active, cp[-1]]))

    def level_indices(self, book, pcap, tcap, num_pixels):
        """(sel, uniq) of one level: the selected pixels (actives, then
        inactives as padding) and the packed triangle slots (present ids,
        then the degenerate row). Either is None when not compacted."""
        sel = uniq = None
        dev = book["ca"].device
        if pcap is not None:
            jpos = torch.arange(pcap, dtype=torch.float32, device=dev) + 0.5
            sa = torch.searchsorted(book["ca"], jpos, side="left")
            si = torch.searchsorted(book["ci"], jpos - book["n_active"],
                                    side="left")
            sel = torch.clamp(torch.where(jpos < book["n_active"], sa, si),
                              0, num_pixels - 1)
        if tcap is not None:
            tpos = torch.arange(tcap, dtype=torch.float32, device=dev) + 0.5
            uniq = torch.clamp(
                torch.searchsorted(book["cp"], tpos, side="left"),
                0, self.union_triangles - 1)
        return sel, uniq

    def __call__(self, states, occ, z_obs, dt, commit=True):
        """One sensor call (see the class docstring): :meth:`plan`, then
        :meth:`apply`."""
        return self.apply(self.plan(states, z_obs, dt), states, occ, z_obs,
                          commit)

    def plan(self, states, z_obs, dt) -> "SensorPlan":
        """What a call decides before its device work:
        :meth:`plan_device`, then :meth:`choose_level`."""
        return self.choose_level(self.plan_device(states, z_obs, dt))

    def triangle_slack(self, states):
        """The inside-test's barycentric slack of every union triangle,
        (Tu,) float32 on the device with no host read: the fixed
        ``bary_slack``, else object ``k``'s automatic slack (ops/slack.py)
        on the triangles of mesh ``k``."""
        from dbot_ros_tpu_torch.ops import slack as slack_mod

        if self._fixed_slack is not None:
            return self._fixed_slack
        zbar = slack_mod.cloud_depth(states[..., 2])        # (K,)
        return torch.cat([
            slack_mod.auto_bary_slack(zbar[k], 1.0 / self._fx, edge,
                                      self.bary_slack_px).expand(
                mesh.padded_triangles)
            for k, (mesh, edge) in enumerate(zip(self.meshes,
                                                 self._median_edges))])

    def plan_device(self, states, z_obs, dt) -> "SensorPlan":
        """The part of :meth:`plan` before its host read: the candidate
        pass, the compaction bookkeeping, the slack of every triangle and
        the model parameters, all on the device (``dt`` a number or a 0-d
        tensor). It reads nothing back, so a CUDA graph can hold it; the
        plan's ``level`` is None until :meth:`choose_level`."""
        cand = self.candidates(states)
        # dt in float32 frame units, as the reference's traced dt
        dtf = as_dt(dt, self.device) * float(np.float32(self.frame_rate))
        params_vec = make_params_vec(self.bp, self.op, dtf)
        book = self.selection(cand) if self.caps(z_obs.shape[0]) else None
        return SensorPlan(cand, params_vec, self.triangle_slack(states), dtf,
                          None, book)

    def choose_level(self, plan: "SensorPlan") -> "SensorPlan":
        """The ladder's level for ``plan``: the tightest whose caps hold
        (n_active, n_uniq), read back in one 8-byte copy, the call's one
        host read (none without a ladder). Sets ``last_level``, and marks
        it for a running profiler with an empty span
        ``dbot.sensor.level:<level>``."""
        caps = self.caps(plan.cand.shape[0])
        level = len(caps)
        if caps:
            with span("dbot.read.ladder"):
                counts = plan.book["counts"].tolist()
            n_active, n_uniq = (int(v) for v in counts)
            level = next((i for i, (pcap, tcap) in enumerate(caps)
                          if (pcap is None or n_active <= pcap)
                          and (tcap is None or n_uniq < tcap)), len(caps))
            with span("dbot.sensor.level", level):
                pass
        self.last_level = level
        return plan._replace(level=level)

    def apply(self, plan: "SensorPlan", states, occ, z_obs, commit=True):
        """The device work of a call at ``plan.level`` (the full level when
        it is ``len(caps)``). Reads nothing back to the host, so a CUDA
        graph can hold it."""
        from dbot_ros_tpu_torch.models import occlusion as occ_mod

        P = states.shape[0]
        p_pad, n_pad = self._pads(P)
        cand, params_vec, dtf = plan.cand, plan.params_vec, plan.dtf
        tri_slack = plan.tri_slack
        N = z_obs.shape[0]
        rays = self.camera.rays
        lazy = isinstance(occ, (tuple, list))
        if lazy and not self._lazy:
            raise ValueError(
                "lazy (q, age) occlusion leaf requires "
                "p_occluded_occluded >= p_occluded_visible")
        q, age = self._unpack_occ(occ)

        def whole_map(gt, cand_use, slack_use):
            # the kernel on every pixel: it ages the rows itself
            ll, q_post = fused_loglik_packed(
                gt, q, z_obs, cand_use, rays, params_vec, P, nb=self.nb,
                ages=None if age is None else age[:N], tri_slack=slack_use)
            if not commit:
                return ll, occ
            return ll, (q_post, torch.zeros_like(age)) if lazy else q_post

        caps = self.caps(N)
        if plan.level == len(caps):
            return whole_map(self.pack_full(states, p_pad), cand, tri_slack)
        book = plan.book
        pcap, tcap = caps[plan.level]
        sel, uniq = self.level_indices(book, pcap, tcap, N)
        if tcap is not None:
            gt = self.pack_selected(states, p_pad, uniq)
            slack_use = tri_slack[uniq]
            inv = torch.clamp(book["cp"].to(torch.int64) - 1, 0, tcap - 1)
            cand_use = inv[cand]
        else:
            gt = self.pack_full(states, p_pad)
            slack_use = tri_slack
            cand_use = cand
        if pcap is None:
            return whole_map(gt, cand_use, slack_use)

        # off-silhouette loglik of the unselected pixels (the kernel's
        # background branch), plus the reference's pixel-padding constant
        bp = self.bp
        inv_range = 1.0 / (bp.max_depth - bp.min_depth)
        z_real = z_obs == z_obs
        z_val = z_real & (z_obs >= bp.min_depth) & (z_obs <= bp.max_depth)
        lik_bg = torch.where(
            z_real, torch.where(z_val, inv_range, 0.0)
            * (1.0 - bp.p_invalid_background), bp.p_invalid_background)
        ll_bg = torch.log(torch.clamp_min(lik_bg, _TINY))
        log_pib = torch.log(torch.clamp_min(bp.p_invalid_background, _TINY))
        sel_mask = book["slot"] < pcap
        n_pad_c = _round_up(pcap, self.nb)
        scalar = (torch.sum(torch.where(sel_mask, 0.0, ll_bg))
                  + (n_pad - N) * log_pib - (n_pad_c - pcap) * log_pib)

        sel32 = torch.clamp(sel, 0, q.shape[0] - 1).to(torch.int32)
        occ_sel = kernels.gather_pixel_rows(q, sel32)
        ll, occ_post = fused_loglik_packed(
            gt, occ_sel, z_obs[sel], cand_use[sel], rays[sel], params_vec,
            P, nb=self.nb, ages=None if age is None else age[sel],
            tri_slack=slack_use)
        if not commit:
            return ll + scalar, occ
        if not lazy:
            # eager: every other pixel's prior propagates over dt, in
            # float32 and cast once; all pcap selected rows are written
            prop = occ_mod.propagate(q.float(), self.op, dtf).to(q.dtype)
            return ll + scalar, kernels.scatter_pixel_rows(prop, occ_post,
                                                           sel32)
        selm = torch.cat([sel_mask, sel_mask.new_zeros((n_pad - N,))])
        age_out = torch.where(selm, 0.0, age + dtf)
        if self.merge == "scatter":
            q_out = kernels.scatter_pixel_rows(q, occ_post, sel32)
        else:
            # inverse row gather of every pixel's posterior row (an
            # unselected pixel's slot names some row: masked) and one
            # select into a new map
            slot = torch.cat([torch.clamp(book["slot"], 0, pcap - 1),
                              book["slot"].new_zeros((n_pad - N,))])
            vals = kernels.gather_pixel_rows(occ_post,
                                             slot.to(torch.int32))
            q_out = torch.where(selm[:, None], vals, q)
        return ll + scalar, (q_out, age_out)


class SensorPlan(NamedTuple):
    """One call's decisions (:meth:`FusedSensor.plan`): the candidate ids
    (N, K), the kernel's parameters (16,), the slack of every union
    triangle (Tu,) (:meth:`FusedSensor.triangle_slack`), dt in frame
    units (a 0-d float32 tensor), the ladder level (``len(caps)``: the
    full level; None before :meth:`FusedSensor.choose_level`) and the
    compaction bookkeeping (:meth:`FusedSensor.selection`; None without a
    ladder)."""
    cand: torch.Tensor
    params_vec: torch.Tensor
    tri_slack: torch.Tensor
    dtf: torch.Tensor
    level: Optional[int]
    book: Optional[dict]


def _params_to(params, device):
    """A params dataclass with every tensor field moved to ``device``."""
    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name).to(device)
        for f in dataclasses.fields(params)})


# the reference's factory name (see FusedSensor for the arguments)
make_fused_sensor = FusedSensor
