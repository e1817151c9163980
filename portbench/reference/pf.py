"""Plain PyTorch reference of one step of the particle tracker: the
Rao-Blackwellized coordinate particle filter (Wüthrich et al., IROS 2013)
with K >= 1 rigid objects and the fused sensor's semantics, the
benchmark's yardstick for the particle cells.

It works a step out again from a belief and a frame, with the noise of
the tracker's own random stream (the transition's drivers and the
resampling uniform are drawn here, from a generator seeded as the
configuration's ``seed`` seeds the tracker's). The state holds one
coordinate block per object, and a step runs the blocks in object order
(``rbcpf_step`` of the port); for block b:

1. the damped-Wiener transition of object b in every particle (frozen
   ``transition.sample_transition``), the other objects as they were;
2. the sensor: one exact raycast of each object at the unweighted mean
   pose of its own particles (frozen ``deferred.raycast_ids``), its
   triangle ids offset by the padded triangle counts of the meshes
   before it, the id images min-combined (a strictly nearer hit wins, a
   tie keeps the earlier object) and dilated into ``num_candidates``
   candidates within ``radius`` pixels (frozen
   ``deferred.candidate_ids``); every particle's z-depth is the nearest
   hit among its pixel's candidates, of whichever object, so objects
   occlude each other, the inside-test relaxed by each object's own
   automatic barycentric slack (frozen ``slack.auto_bary_slack``, at the
   mean depth of that object's particles, in its own median edge); the
   beam model with the truncation normaliser taken as 1 and the
   occlusion chain aged in closed form give each pixel's marginal and
   occlusion posterior, as ``dbot_ros_tpu_torch/ops/kernels.py``
   ``fused_loglik_plain`` states the kernel's arithmetic; a pixel none of
   whose candidates is a triangle is off the silhouette for every
   particle;
3. the telescoping weight update ``log_w + loglik_b - loglik_{b-1}``
   (nothing subtracted at block 0) and the KL-triggered systematic
   resampling (frozen ``resample``), which carries the block's
   log-likelihoods along; the occlusion posterior is committed at the
   last block only, the blocks before it resample the map they were
   given. A block before the last resamples through the program's own
   parents where the step is given the particles the program carried
   out of it (:meth:`ParticleReference.recover_parents`): its
   systematic parents flip with the float32 rounding of the
   log-likelihoods, and the blocks after it would weigh the flipped
   particles by their own telescoped log-likelihoods. Those parents are
   judged, not trusted: every carried particle must be a proposal that
   the recovered parents give (``parents_gap``), and each recovered
   threshold must lie in its parent's step of the reference's own CDF to
   within what the rounding of the log-weights moves it (``parents_cdf``);
4. the weighted chordal mean of each object (frozen ``se3.states_mean``)
   and the weighted mean of the last block's log-likelihood, in each
   object's model frame.

The ladder of compacted levels, the packing product, the row gathers and
the CUDA graphs of the port change none of these numbers beyond rounding,
so the reference has none of them. Nothing here imports the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from .frozen import deferred, raycast, resample as rs, se3, slack
from .frozen.transition import make_transition_params, sample_transition
from . import scene

_TINY = 1e-30
_DET_EPS = 1e-12
_NEAR = 1e-4
_BIG = 1e30
_SQRT2PI = 2.5066282746310002
# the fused sensor's defaults (``make_fused_sensor``)
SENSOR_DEFAULTS = {"num_candidates": 2, "radius": 2, "bary_slack_px": 0.25}
NEVER_RESAMPLE_KL = 1e8
# the beam model's point masses of an invalid return (NaN), which the
# tracker's configuration does not set: the trackers' defaults
P_INVALID = {"occluded": 0.1, "visible": 0.01, "background": 0.3}
# a KL this close to the trigger may go either way by rounding: both
# branches are then answers
KL_AMBIGUITY = 1e-4
# how many carried particles are matched at a time
PARENT_CHUNK = 256
# how many candidate parents the last block weighs at a time for the
# particles whose recovered parent weighs more than it can have
REFIT_CHUNK = 4096


@dataclasses.dataclass
class Belief:
    """Particles (P, K, 13), log weights (P,), the occlusion map (P, N)
    and each pixel's age (N,) in frames: the map holds a pixel's
    probability as of ``age`` frames ago."""

    states: torch.Tensor
    log_weights: torch.Tensor
    occ: torch.Tensor
    age: torch.Tensor

    def clone(self) -> "Belief":
        return Belief(*(x.clone() for x in dataclasses.astuple(self)))


@dataclasses.dataclass
class Answer:
    """Where a step ends: the particles (P, K, 13), their weighted mean
    state (K, 13) and the model-frame poses (K, 7)."""

    states: torch.Tensor
    mean_state: torch.Tensor
    pose: torch.Tensor


@dataclasses.dataclass
class Step:
    """One reference step: the new belief, its mean state (K, 13), the
    model-frame poses (K, 7), the mean log-likelihood, the last block's
    KL before resampling, whether any block resampled, and the other
    answers (:class:`Answer`), one for each other way the step could go
    where a block's KL lay within rounding of the trigger (at most
    2^K - 1)."""

    belief: Belief
    mean_state: torch.Tensor
    pose: torch.Tensor
    mean_loglik: torch.Tensor
    kl: float
    resampled: bool
    others: list = dataclasses.field(default_factory=list)
    # a block before the last resampled on some way through the step
    early_resample: bool = False
    # the largest position gap (m) of a carried particle to the proposal
    # its recovered parents give, on the way that matches best (None: no
    # parents recovered)
    parents_gap: object = None
    # on that way, the largest distance of a recovered parent's threshold
    # from its step of the reference's CDF, a share of the weight (None:
    # no parents recovered)
    parents_cdf: object = None

    def answers(self):
        """Every answer, this step's first."""
        return [Answer(self.belief.states, self.mean_state, self.pose),
                *self.others]


@dataclasses.dataclass
class _Path:
    """One way through a step's blocks so far: the particles, the
    occlusion map they carry, their log weights, the last block's
    log-likelihood in the particles' order (None before the first
    block), the one in the sensor's order, whether a block resampled,
    and the last KL."""

    states: torch.Tensor
    occ: torch.Tensor
    log_w: torch.Tensor
    old: object = None
    loglik: object = None
    resampled: bool = False
    kl: float = 0.0
    early: bool = False         # a block before the last resampled
    parents_gap: object = None  # the largest gap of its recovered parents
    parents_cdf: object = None  # their thresholds' largest CDF gap
    # block b's proposals, map and log-likelihoods before its recovered
    # resampling, and which parents no carried particle fixed, where block
    # b+1 is the last (:meth:`ParticleReference._refit`)
    prev: object = None


def tf32_round(x):
    """The value TF32 holds of each float32 element: 10 explicit mantissa
    bits, rounded to nearest even (other tensors pass unchanged)."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _rounding(fn):
    def call(*args, **kwargs):
        return fn(*(tf32_round(a) for a in args), **kwargs)
    return call


_PRODUCTS = ((torch, "matmul"), (torch, "mm"), (torch, "bmm"),
             (torch, "einsum"), (torch.Tensor, "matmul"),
             (torch.Tensor, "__matmul__"))


@contextlib.contextmanager
def precision(name: str):
    """``float32`` (TF32 off, the configuration's) or ``tf32`` (the
    control: every matrix product takes its float32 inputs rounded to
    TF32, as the card's TF32 mode does, whatever kernel cuBLAS picks; a
    product with an inner size of 3 is often run in float32 FMA even with
    TF32 allowed, so the flag alone does not give TF32)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr in _PRODUCTS]
    if name == "tf32":
        for obj, attr, fn in saved:
            setattr(obj, attr, _rounding(fn))
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
        torch.backends.cuda.matmul.allow_tf32 = old


class ParticleReference:
    """The reference of ``config`` (the tracker's configuration as a
    dict) with the meshes ``obj_texts`` (OBJ texts, one per tracked
    object in the tracker's order), on ``device``."""

    def __init__(self, config: dict, obj_texts, device):
        if int(config.get("evaluation_count", 0)) <= 0:
            raise ValueError("evaluation_count must be positive")
        self.device = torch.device(device)
        self.config = config
        obj = config["object"]
        self.meshes = [scene.object_mesh(text, obj.get("center_object",
                                                       True), self.device)
                       for text in obj_texts]
        self.K = len(self.meshes)
        self.centers = torch.stack([m.center for m in self.meshes])
        self.camera = scene.camera_for(config["camera"], self.device)
        self.P = int(config["evaluation_count"])
        self.N = self.camera.num_pixels
        self.frame_rate = float(config["camera"]["frame_rate"])
        self.max_kl = float(config["max_kl_divergence"])
        opts = {**SENSOR_DEFAULTS, **(config.get("backend_options") or {})}
        self.num_candidates = int(opts["num_candidates"])
        self.radius = int(opts["radius"])
        self.slack_px = float(opts["bary_slack_px"])
        self.fixed_slack = opts.get("bary_slack")
        obs = config["observation"]
        f = lambda x: torch.tensor(float(x), dtype=torch.float32,  # noqa
                                   device=self.device)
        self.obs = {k: f(v) for k, v in obs.items()}
        self.p_invalid = {k: f(v) for k, v in P_INVALID.items()}
        tr = config["transition"]
        self.trans = make_transition_params(
            tr["linear_acceleration_sigma"], tr["angular_acceleration_sigma"],
            tr["damping"], device=self.device)
        # each mesh in its own units; its triangles' ids in the union
        # table start after the padded triangles of the meshes before it
        self.med_edges = [slack.median_edge([m]) for m in self.meshes]
        sizes = [m.padded_triangles for m in self.meshes]
        self.offsets = [sum(sizes[:k]) for k in range(self.K)]
        self.fx = float(self.camera.camera_matrix[0, 0])
        self.deg = sum(sizes) - 1
        self.seed = int(config["seed"])

    # -- the random stream ---------------------------------------------
    def generator(self) -> torch.Generator:
        """The tracker's stream, as a fresh tracker seeds it."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        return g

    def draw(self, gen):
        """One step's numbers, in the tracker's order: for each block
        e1, e2 (P, 6), then the resampling uniform (none when it never
        resamples); a list of K (e1, e2, u)."""
        out = []
        for _ in range(self.K):
            e1 = torch.randn((self.P, 6), generator=gen, device=self.device)
            e2 = torch.randn((self.P, 6), generator=gen, device=self.device)
            u = (torch.rand((), generator=gen, device=self.device)
                 if self.max_kl < NEVER_RESAMPLE_KL else None)
            out.append((e1, e2, u))
        return out

    # -- beliefs ---------------------------------------------------------
    def initial(self, pose_model) -> Belief:
        """All particles at the model-frame poses (K, 7) (or (7,) of one
        object), zero velocity, uniform weights, every pixel at the
        initial occlusion probability."""
        pose = torch.as_tensor(np.asarray(pose_model, np.float32),
                               device=self.device).reshape(self.K, 7)
        pc = scene.to_center_frame(pose, self.centers)
        states = torch.zeros((self.P, self.K, 13), device=self.device)
        states[..., :7] = pc[None]
        p0 = float(self.config["observation"]["initial_occlusion_prob"])
        return Belief(states, torch.zeros((self.P,), device=self.device),
                      torch.full((self.P, self.N), p0, device=self.device),
                      torch.zeros((self.N,), device=self.device))

    def from_program(self, states, log_weights, occlusion) -> Belief:
        """A belief held in the tracker's layout (states (P, K, 13); its
        leaf: the pixel-major (n_pad, p_pad) map, with or without (n_pad,)
        ages), copied into the reference's, values unchanged (float32)."""
        if states.shape[1] != self.K:
            raise ValueError(f"{states.shape[1]} objects in the belief, "
                             f"{self.K} meshes")
        q, age = (occlusion if isinstance(occlusion, (tuple, list))
                  else (occlusion, None))
        occ = q[:self.N, :self.P].float().T.contiguous()
        age = (torch.zeros((self.N,), device=self.device) if age is None
               else age[:self.N].float().clone())
        return Belief(states.float().clone(), log_weights.float().clone(),
                      occ, age)

    def to_model_frame(self, mean_state):
        """Centred-frame mean states (K, 13) → model-frame poses (K, 7)."""
        return scene.to_model_frame(mean_state[:, :7], self.centers)

    # -- the step ----------------------------------------------------------
    def candidates(self, states):
        """(N, C) candidate ids into the union of every object's padded
        triangles, from one raycast of each object at the unweighted mean
        pose of its particles; misses name the union's degenerate last
        triangle."""
        z_best = ids_best = None
        for k, (mesh, offset) in enumerate(zip(self.meshes, self.offsets)):
            ref = se3.states_mean(states[:, k])[:7]
            z_k, ids_k = deferred.raycast_ids(mesh, ref, self.camera.rays)
            ids_k = torch.where(ids_k >= 0, ids_k + offset, -1)
            if z_best is None:
                z_best, ids_best = z_k, ids_k
            else:
                closer = z_k < z_best
                z_best = torch.where(closer, z_k, z_best)
                ids_best = torch.where(closer, ids_k, ids_best)
        cand = deferred.candidate_ids(ids_best, self.camera.height,
                                      self.camera.width, self.radius,
                                      self.num_candidates)
        return torch.where(cand >= 0, cand, self.deg)

    def candidate_counts(self, pose_model):
        """(n_active, n_uniq) of the candidate table at one frame's
        model-frame poses (K, 7): the pixels with a candidate triangle,
        and the distinct ids in the table (the degenerate one among
        them)."""
        pose = torch.as_tensor(np.asarray(pose_model, np.float32),
                               device=self.device).reshape(self.K, 7)
        states = torch.zeros((1, self.K, 13), device=self.device)
        states[..., :7] = scene.to_center_frame(pose, self.centers)
        cand = self.candidates(states)
        return (int(torch.any(cand != self.deg, dim=1).sum()),
                int(torch.unique(cand).numel()))

    def triangle_slack(self, states):
        """The inside-test's slack of every union triangle (Tu,): the
        fixed ``bary_slack``, else each object's automatic slack on its
        own triangles."""
        if self.fixed_slack is not None:
            return torch.full((self.deg + 1,), float(self.fixed_slack),
                              device=self.device)
        return torch.cat([
            slack.auto_bary_slack(slack.cloud_depth(states[..., k, 2]),
                                  1.0 / self.fx, edge, self.slack_px)
            .expand(mesh.padded_triangles)
            for k, (mesh, edge) in enumerate(zip(self.meshes,
                                                 self.med_edges))])

    def table(self, states):
        """The candidate ids (N, C) and the slack of every triangle (Tu,)
        of one sensor call on ``states``."""
        return self.candidates(states), self.triangle_slack(states)

    def sense(self, states, occ, age, z, dtf, table=None):
        """(loglik (P,), occlusion posterior (P, N)) of ``states`` on the
        flat frame ``z``, with the candidate table and slack of ``table``
        (:meth:`table`; by default those of ``states``)."""
        o = self.obs
        wt, minz, maxz = o["tail_weight"], o["min_depth"], o["max_depth"]
        lam = o["exponential_rate"]
        p_inv_occ, p_inv_vis, p_inv_bg = (
            self.p_invalid[k] for k in ("occluded", "visible", "background"))
        inv_range = 1.0 / (maxz - minz)
        g = o["p_occluded_occluded"] - o["p_occluded_visible"]
        pi = o["p_occluded_visible"] / torch.clamp_min(1.0 - g, 1e-12)
        lg = torch.log(torch.clamp_min(torch.abs(g), 1e-30))
        sgn = torch.sign(g)

        cand, sl = self.table(states) if table is None else table
        active = torch.any(cand != self.deg, dim=1)         # cand (N, C)
        act = torch.nonzero(active)[:, 0]
        consts = [raycast.pose_tri_constants(m, states[:, k, :7])
                  for k, m in enumerate(self.meshes)]
        G = torch.cat([c[0] for c in consts], dim=1)         # (P, Tu, 3, 3)
        t_num = torch.cat([c[1] for c in consts], dim=1)     # (P, Tu)

        z_real = z == z
        z_valid = z_real & (z >= minz) & (z <= maxz)
        zz = torch.where(z_real, z, 1.0)
        lik_bg = torch.where(z_real, torch.where(z_valid, inv_range, 0.0)
                             * (1.0 - p_inv_bg), p_inv_bg)

        geff = sgn * torch.exp(lg * (age + dtf))             # (N,)
        q_all = torch.clamp(pi + geff[None] * (occ - pi), 0.0, 1.0)

        rays = self.camera.rays[act]                         # (n, 3)
        t = None
        for k in range(cand.shape[1]):
            ids = cand[act, k]
            Gk = G[:, ids]                                   # (P, n, 3, 3)
            num = torch.einsum("pnij,nj->pni", Gk, rays)
            u, v, det = num[..., 0], num[..., 1], num[..., 2]
            tn = t_num[:, ids]
            s = torch.sign(det)
            adet = torch.abs(det)
            sa = sl[ids] * adet
            valid = ((adet > _DET_EPS) & (s * u >= -sa) & (s * v >= -sa)
                     & (s * (u + v) <= adet + sa) & (s * tn > _NEAR * adet))
            tk = torch.where(valid, tn / torch.where(valid, det, 1.0), _BIG)
            t = tk if t is None else torch.minimum(t, tk)
        on_sil = t < _BIG * 0.5
        d = torch.where(on_sil, t, 1.0)

        q = q_all[:, act]
        za, zv, zr = zz[act][None], z_valid[act][None], z_real[act][None]
        sig = o["model_sigma"] + o["sigma_factor"] * d * d
        zn = (za - d) / sig
        body_vis = torch.exp(-0.5 * zn * zn) / (sig * _SQRT2PI)
        lik_vis = torch.where(
            zv, ((1.0 - wt) * body_vis + wt * inv_range) * (1.0 - p_inv_vis),
            p_inv_vis)
        d_eff = torch.minimum(torch.maximum(d, minz), maxz)
        span = torch.clamp_min(d_eff - minz, 1e-6)
        norm_occ = torch.clamp_min(1.0 - torch.exp(-lam * span), 1e-6)
        body_occ = lam * torch.exp(-lam * (za - minz)) / norm_occ
        in_front = zv & (za <= d_eff)
        lik_occ = torch.where(
            zr, ((1.0 - wt) * torch.where(in_front, body_occ, 0.0)
                 + wt * torch.where(zv, inv_range, 0.0)) * (1.0 - p_inv_occ),
            p_inv_occ)
        p_on = (1.0 - q) * lik_vis + q * lik_occ
        p_z = torch.clamp_min(torch.where(on_sil, p_on, lik_bg[act][None]),
                              _TINY)
        post = q * lik_occ / torch.clamp_min(p_on, _TINY)
        post = torch.where(on_sil, torch.clamp(post, 0.0, 1.0), q)

        ll_off = torch.sum(torch.where(
            active, 0.0, torch.log(torch.clamp_min(lik_bg, _TINY))))
        loglik = torch.log(p_z).sum(dim=1) + ll_off
        q_all[:, act] = post
        return loglik, q_all

    def step(self, bel: Belief, z, dt, draws, dtype: str = "float32",
             carried=None):
        """One step of ``bel`` on the frame ``z`` over ``dt`` seconds with
        ``draws`` (:meth:`draw`), computed in ``dtype`` (``float32`` or
        the control's ``tf32``); ``carried``: the particles (P, K, 13) the
        program carried out of the step, from which a block before the
        last takes the program's resampling parents."""
        with precision(dtype):
            return self._step(bel, z, dt, draws, carried)

    def _step(self, bel: Belief, z, dt, draws, carried=None) -> Step:
        z = scene.preprocess(torch.as_tensor(z, device=self.device))
        dt_t = torch.full((), float(np.float32(dt)), dtype=torch.float32,
                          device=self.device)
        dtf = dt_t * float(np.float32(self.frame_rate))
        # the first path takes the trigger's side at every block; a block
        # whose KL lies within rounding of it forks the other side too
        paths = [_Path(bel.states, bel.occ, bel.log_weights)]
        for b, noise in enumerate(draws):
            nxt = draws[b + 1] if b + 1 < len(draws) else None
            paths = [fork for path in paths for fork in
                     self._block(path, b, noise, bel.age, z, dt_t, dtf,
                                 carried, nxt)]
        answers = []
        for path in paths:
            ln, _ = rs.normalize_log_weights(path.log_w)
            w = torch.exp(ln)
            ms = se3.states_mean(path.states, w)             # (K, 13)
            answers.append((ms, torch.sum(w * path.loglik)))
        main = paths[0]
        (ms, ml), others = answers[0], answers[1:]
        new = Belief(main.states, main.log_w, main.occ,
                     torch.zeros_like(bel.age))
        # the way the program went matches its carried particles best
        fits = [(p.parents_gap, p.parents_cdf) for p in paths
                if p.parents_gap is not None]
        gap, off = min(fits, default=(None, None))
        return Step(new, ms, self.to_model_frame(ms), ml, main.kl,
                    main.resampled,
                    [Answer(p.states, m, self.to_model_frame(m))
                     for p, (m, _) in zip(paths[1:], others)],
                    any(p.early for p in paths), gap, off)

    def _block(self, path: _Path, b: int, noise, age, z, dt_t, dtf,
               carried=None, next_noise=None):
        """Block ``b`` of one path: object b proposed, the sensor, the
        weight update and the resampling (before the last block, through
        the parents recovered from ``carried`` where it is given); the
        paths it leads to (two where the KL lies within rounding of the
        trigger)."""
        e1, e2, u = noise
        last = b == self.K - 1
        states = path.states.clone()
        states[:, b] = sample_transition(path.states[:, b], dt_t, self.trans,
                                         e1=e1, e2=e2)
        table = self.table(states)
        loglik, post = self.sense(states, path.occ, age, z, dtf, table)
        log_w = (path.log_w + loglik if path.old is None
                 else path.log_w + loglik - path.old)
        if path.prev is not None:
            self._refit(path, b, noise, states, loglik, post, log_w, age, z,
                        dt_t, dtf, table)
        occ = post if last else path.occ
        kl = rs.kl_to_uniform(log_w)
        kl_f = float(kl)

        def branch(do):
            if not do:
                return _Path(states, occ, log_w, loglik, loglik,
                             path.resampled, kl_f, path.early,
                             path.parents_gap, path.parents_cdf,
                             None if last else path.prev)
            gap, off_cdf, prev = path.parents_gap, path.parents_cdf, None
            if carried is not None and not last:
                idx, got, off, unfixed, lo, hi = self.recover_parents(
                    log_w, u, states, b, carried, next_noise, dt_t)
                gap = max(gap or 0.0, got)
                off_cdf = max(off_cdf or 0.0, off)
                if b + 1 == self.K - 1:
                    prev = dict(states=states, occ=occ, old=loglik, idx=idx,
                                unfixed=unfixed, lo=lo, hi=hi)
            else:
                idx = rs.systematic_indices(log_w, self.P, u=u)
                idx = idx.clamp(0, self.P - 1)
            return _Path(states.index_select(0, idx),
                         occ.index_select(0, idx), torch.zeros_like(log_w),
                         loglik.index_select(0, idx), loglik, True, kl_f,
                         path.early or not last, gap, off_cdf, prev)

        resamples = self.max_kl < NEVER_RESAMPLE_KL
        do = resamples and kl_f > self.max_kl
        out = [branch(do)]
        if resamples and abs(kl_f - self.max_kl) <= KL_AMBIGUITY * max(
                1.0, self.max_kl):
            out.append(branch(not do))
        return out

    def recover_parents(self, log_w, u, states, b, carried, noise, dt_t):
        """Block ``b``'s resampling parents as the program drew them, the
        largest position gap (m) of the carried particles to the
        proposals those parents give, and how far they lie from
        systematic resampling over the reference's weights.

        The program's parents are systematic resampling's over its own
        weights, which differ from the reference's (``log_w``) by float32
        rounding: by one scale of the whole normalised CDF (the
        log-sum-exp of log-weights of ~10^4 nats is exact to ~10^-3), by
        an ulp or so of each particle's log-weight, and now and then by
        far more for one particle whose ray grazes a triangle's edge, so
        that a pixel hits in one and misses in the other. A threshold
        near a step of the CDF then picks a neighbouring parent, or one
        many particles away across a run of particles of negligible
        weight.

        A carried particle j holds object b as ``states[k, b]``, block
        b's proposal of its parent k, which its own noise names (particles
        that one resampling copied share their other objects), and object
        b+1, first proposed in block b+1, as ``T(states[k, b+1],
        noise[i])``: particle i's proposal from parent k (``T`` the
        transition). So k is the block-b proposal nearest to the carried
        object b, and i the particle whose velocity driver ``e1`` takes
        parent k's velocity to the carried one (``v' = a v + sd e1``);
        the pair's proposal is then worked out again and compared. That
        fixes the program's parent of every particle that a carried
        particle descends from, whatever the CDF. Every other particle
        takes its parent under the program's CDF as the fixed ones bound
        it (:func:`_program_cdf`), clamped between the parents of its
        nearest fixed neighbours (the parents are nondecreasing in i);
        where the next block is the last, :meth:`_refit` corrects those
        that weigh there more than they can have.

        Returns the parents, the gap, the pairs' distance from the
        reference's CDF (:func:`_cdf_gap`), which particles no carried
        particle fixed, and each particle's lowest and highest allowed
        parent."""
        P = self.P
        e1, e2, _ = noise
        ln, _ = rs.normalize_log_weights(log_w)
        cdf = rs.weight_cdf(torch.exp(ln)).double()
        pos = ((torch.arange(P, dtype=torch.float32, device=self.device)
                + u) / P).double()
        carried = carried.to(self.device)

        # k: the block-b proposal nearest to each carried object b
        k_of, gap = _nearest(carried[:, b, :3], states[:, b, :3])
        # i: the velocity driver that takes k's object b+1 to the carried
        tr = self.trans
        damp = torch.exp(-tr.damping * dt_t).double()
        sd = (torch.cat([tr.linear_acceleration_sigma.expand(3),
                         tr.angular_acceleration_sigma.expand(3)])
              * torch.sqrt(dt_t)).double()
        drive = (carried[:, b + 1, 7:13].double()
                 - damp * states[k_of, b + 1, 7:13].double()) / sd
        known_i, _ = _nearest(drive, e1)
        prop = sample_transition(states[k_of, b + 1], dt_t, tr,
                                 e1=e1[known_i], e2=e2[known_i])
        gap_i = float(torch.linalg.norm(
            prop[:, :3].double() - carried[:, b + 1, :3].double(),
            dim=-1).max())

        est = _program_cdf(cdf, pos, known_i, k_of)
        idx = torch.searchsorted(est, pos, side="left").clamp(
            0, P - 1).to(k_of.dtype)
        lo = torch.full((P,), -1, dtype=idx.dtype, device=self.device)
        lo[known_i] = k_of
        hi = torch.full((P,), P - 1, dtype=idx.dtype, device=self.device)
        hi[known_i] = k_of
        lo = torch.cummax(lo, dim=0).values.clamp_min(0)
        hi = torch.cummin(hi.flip(0), dim=0).values.flip(0)
        unfixed = torch.ones((P,), dtype=torch.bool, device=self.device)
        unfixed[known_i] = False
        return (torch.maximum(torch.minimum(idx, hi), lo),
                max(gap, gap_i), _cdf_gap(cdf, pos, known_i, k_of),
                unfixed, lo, hi)

    def _refit(self, path, b, noise, states, loglik, post, log_w, age, z,
               dt_t, dtf, table):
        """The last block (``b``) after a resampling whose parents were
        recovered: a particle that no carried particle descends from was
        drawn no times by the program's last resampling, so its weight
        there was under 1/P. Where the reference's is 1/P or more, its
        recovered parent is wrong: it takes, of every parent that its
        fixed neighbours allow, the one that weighs least. ``states``,
        ``loglik``, ``post`` and ``log_w`` are updated in place."""
        prev = path.prev
        ln, _ = rs.normalize_log_weights(log_w)
        heavy = prev["unfixed"] & (torch.exp(ln) * self.P >= 1.0)
        sus = torch.nonzero(heavy)[:, 0]
        if sus.numel() == 0:
            return
        e1, e2, _ = noise
        lo, n = prev["lo"][sus], prev["hi"][sus] - prev["lo"][sus] + 1
        seg = torch.repeat_interleave(
            torch.arange(sus.numel(), device=self.device), n)
        k = lo[seg] + torch.arange(seg.numel(), device=self.device) - (
            torch.cumsum(n, 0) - n)[seg]
        i = sus[seg]

        def weigh(i, k):
            alt = prev["states"][k].clone()
            alt[:, b] = sample_transition(prev["states"][k, b], dt_t,
                                          self.trans, e1=e1[i], e2=e2[i])
            ll, q = self.sense(alt, prev["occ"][k], age, z, dtf, table)
            return alt, ll, q, path.log_w[i] + ll - prev["old"][k]

        lw = torch.cat([weigh(i[c:c + REFIT_CHUNK], k[c:c + REFIT_CHUNK])[3]
                        for c in range(0, seg.numel(), REFIT_CHUNK)])
        least = torch.full((sus.numel(),), math.inf, device=self.device)
        least = least.scatter_reduce(0, seg, lw, "amin")
        at = torch.nonzero(lw == least[seg])[:, 0]
        pick = torch.full((sus.numel(),), seg.numel(), device=self.device,
                          dtype=at.dtype)
        pick = pick.scatter_reduce(0, seg[at], at, "amin")
        alt, ll, q, lw = weigh(i[pick], k[pick])
        states[sus], loglik[sus], post[sus], log_w[sus] = alt, ll, q, lw


def _left(cdf):
    """Each step's lower end: the CDF before it (0 before the first)."""
    return torch.cat([cdf.new_zeros(1), cdf[:-1]])


def _nearest(a, b):
    """Index into ``b`` (M, d) of the point nearest each of ``a`` (P, d),
    and the largest such distance, in float64."""
    a, b = a.double(), b.double()
    out, gap = [], 0.0
    for s in range(0, a.shape[0], PARENT_CHUNK):
        d = torch.cdist(a[s:s + PARENT_CHUNK], b,
                        compute_mode="donot_use_mm_for_euclid_dist")
        dm, im = d.min(dim=1)
        out.append(im)
        gap = max(gap, float(dm.max()))
    return torch.cat(out), gap


def _program_cdf(cdf, pos, known_i, known_k):
    """The program's CDF, estimated from the matched pairs (i, k): the
    reference's under the scale that agrees with the most of them
    (:func:`_best_scale`), moved where that breaks a pin. Where the parent
    changes from k1 to k2 between two consecutive matched particles i1 <
    i2, the program's CDF at k1 lies in [pos[i1], pos[i2]); the scaled
    CDF there is clipped into that range, and the shift interpolated
    between such pins (held beyond the first and the last)."""
    scale = _best_scale(cdf, pos, known_i, known_k)
    c = cdf.cpu().numpy() * scale
    p = pos.cpu().numpy()
    i, first = np.unique(known_i.cpu().numpy(), return_index=True)
    k = known_k.cpu().numpy()[first]
    step = np.nonzero(k[1:] > k[:-1])[0]
    if step.size:
        at = k[step]
        lo, hi = p[i[step]], np.nextafter(p[i[step + 1]], -np.inf)
        shift = np.clip(c[at], lo, hi) - c[at]
        c = c + np.interp(np.arange(c.size), at, shift)
    return torch.as_tensor(c, dtype=cdf.dtype, device=cdf.device)


def _cdf_gap(cdf, pos, known_i, known_k):
    """How far the matched pairs (i, k) lie from systematic resampling's
    over the reference's CDF, ``cdf[k-1] < pos[i] <= cdf[k]`` (the last
    particle's step open above: the parents are clamped): the largest
    distance of a threshold outside its parent's step, a share of the
    whole weight. It bounds from below the largest gap between the CDF
    the program resampled from and the reference's."""
    c = cdf.double()
    lower = _left(c)[known_k]
    upper = torch.where(known_k == c.numel() - 1, math.inf, c[known_k])
    p = pos[known_i].double()
    return float(torch.maximum((lower - p).clamp_min(0.0),
                               (p - upper).clamp_min(0.0)).max())


def _best_scale(cdf, pos, known_i, known_k):
    """The scale s of the CDF under which the most matched pairs (i, k)
    are systematic resampling's, ``cdf[k-1] < pos[i] / s <= cdf[k]``:
    the middle of the widest run of the sweep over the pairs' intervals
    of s that the most of them share."""
    c = cdf.cpu().numpy()
    p = pos[known_i].cpu().numpy()
    k = known_k.cpu().numpy()
    upper = np.where(k > 0, p / np.maximum(c[np.maximum(k - 1, 0)], 1e-300),
                     np.inf)                  # s < upper
    lower = p / np.maximum(c[k], 1e-300)      # s >= lower
    events = sorted([(x, 1) for x in lower] + [(x, -1) for x in upper])
    best, depth, at = -1, 0, 1.0
    for j, (x, d) in enumerate(events):
        depth += d
        if d > 0 and j + 1 < len(events) and depth >= best:
            # the run [x, nxt) shares ``depth`` pairs: its point nearest 1
            nxt = events[j + 1][0]
            near = min(max(1.0, x), np.nextafter(nxt, -np.inf))
            if depth > best or abs(near - 1.0) < abs(at - 1.0):
                best, at = depth, near
    return float(at)


def pose_gaps(a, b):
    """Gaps between model-frame poses ``a`` and ``b`` (..., 7), each the
    largest over the leading axes: (lateral m, scale, rotation rad).

    The position gap is split along ``b``'s position vector. A filter's
    float32 mean is Σ wᵢ·xᵢ with weights normalised by a log-sum-exp of
    log-weights of magnitude ~10^4, whose rounding leaves Σ wᵢ off 1 by up
    to a few 10^-4: that scales the whole position (``scale``, the
    relative change of its length) and moves nothing sideways
    (``lateral``, the rest of the gap). The angle is
    4·asin(‖q_a − s·q_b‖ / 2) with s the sign of their dot product, which
    stays exact near zero (an arccos of the dot product would read float32
    rounding of the norms as half a milliradian)."""
    a = torch.as_tensor(a, dtype=torch.float64).reshape(-1, 7)
    b = torch.as_tensor(b, dtype=torch.float64).reshape(-1, 7)
    tb = b[:, :3]
    nb = torch.linalg.norm(tb, dim=-1, keepdim=True).clamp_min(1e-12)
    d = a[:, :3] - tb
    along = torch.sum(d * tb / nb, dim=-1, keepdim=True)
    lateral = torch.linalg.norm(d - along * tb / nb, dim=-1).max()
    scale = torch.abs(along[:, 0] / nb[:, 0]).max()
    qa = a[:, 3:] / torch.linalg.norm(a[:, 3:], dim=-1, keepdim=True)
    qb = b[:, 3:] / torch.linalg.norm(b[:, 3:], dim=-1, keepdim=True)
    s = torch.where(torch.sum(qa * qb, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    chord = torch.linalg.norm(qa - s * qb, dim=-1).clamp(max=2.0)
    rot = (4.0 * torch.asin(chord / 2.0)).max()
    return float(lateral), float(scale), float(rot)


def particle_gap(states, want):
    """The median over particles of their largest position gap (m) over
    the objects between two sets of particle states (P, K, 13) in the
    same order: one particle whose resampling parent went the other way
    by rounding moves no median."""
    d = states[..., :3].double() - want[..., :3].double()
    return float(torch.linalg.norm(d, dim=-1).amax(dim=-1).median())


def velocity_gap(a, b):
    """The largest gap over the objects between two mean states (K, 13)'
    linear velocities (m/s)."""
    d = a[:, 7:10].double() - b[:, 7:10].double()
    return float(torch.linalg.norm(d, dim=-1).max())


def weighted_mean_state(states, log_weights):
    """The weighted mean state (K, 13) of particles."""
    ln, _ = rs.normalize_log_weights(log_weights.float())
    return se3.states_mean(states.float(), torch.exp(ln))


def weighted_mean_pose(ref: ParticleReference, states, log_weights):
    """The model-frame weighted mean poses (K, 7) of particles."""
    return ref.to_model_frame(weighted_mean_state(states, log_weights))
