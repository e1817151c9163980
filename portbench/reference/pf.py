"""Plain PyTorch reference of one step of the particle tracker: the
Rao-Blackwellized coordinate particle filter (Wüthrich et al., IROS 2013)
with one object and the fused sensor's semantics, the benchmark's
yardstick for the particle cells.

It works a step out again from a belief and a frame, with the noise of
the tracker's own random stream (the transition's drivers and the
resampling uniform are drawn here, from a generator seeded as the
configuration's ``seed`` seeds the tracker's):

1. the damped-Wiener transition of every particle (frozen
   ``transition.sample_transition``);
2. the sensor: one exact raycast at the particles' unweighted mean pose
   names each pixel's nearest triangle (frozen ``deferred.raycast_ids``),
   dilated into ``num_candidates`` candidates within ``radius`` pixels
   (frozen ``deferred.candidate_ids``); every particle's z-depth is the
   nearest hit among its pixel's candidates, the inside-test relaxed by
   the automatic barycentric slack (frozen ``slack.auto_bary_slack``);
   the beam model with the truncation normaliser taken as 1 and the
   occlusion chain aged in closed form give each pixel's marginal and
   occlusion posterior, as ``dbot_ros_tpu_torch/ops/kernels.py``
   ``fused_loglik_plain`` states the kernel's arithmetic; a pixel none of
   whose candidates is a triangle is off the silhouette for every
   particle;
3. the weight update and the KL-triggered systematic resampling (frozen
   ``resample``);
4. the weighted chordal mean (frozen ``se3.states_mean``) and the
   weighted mean log-likelihood, in the model frame.

The ladder of compacted levels, the packing product, the row gathers and
the CUDA graphs of the port change none of these numbers beyond rounding,
so the reference has none of them. Nothing here imports the port.
"""

from __future__ import annotations

import contextlib
import dataclasses

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


@dataclasses.dataclass
class Belief:
    """Particles (P, 1, 13), log weights (P,), the occlusion map (P, N)
    and each pixel's age (N,) in frames: the map holds a pixel's
    probability as of ``age`` frames ago."""

    states: torch.Tensor
    log_weights: torch.Tensor
    occ: torch.Tensor
    age: torch.Tensor

    def clone(self) -> "Belief":
        return Belief(*(x.clone() for x in dataclasses.astuple(self)))


@dataclasses.dataclass
class Step:
    """One reference step: the new belief, its mean state (1, 13), the
    model-frame pose (1, 7), the mean log-likelihood, the KL before
    resampling, whether it resampled, and the other branch's pose and
    particles where the KL lay within rounding of the trigger (else
    None)."""

    belief: Belief
    mean_state: torch.Tensor
    pose: torch.Tensor
    mean_loglik: torch.Tensor
    kl: float
    resampled: bool
    other_pose: object = None
    other_states: object = None
    other_mean_state: object = None


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
    dict) with the mesh ``obj_text``, on ``device``."""

    def __init__(self, config: dict, obj_text: str, device):
        if int(config.get("evaluation_count", 0)) <= 0:
            raise ValueError("evaluation_count must be positive")
        self.device = torch.device(device)
        self.config = config
        obj = config["object"]
        self.mesh = scene.object_mesh(obj_text, obj.get("center_object",
                                                        True), self.device)
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
        self.med_edge = slack.median_edge([self.mesh])
        self.fx = float(self.camera.camera_matrix[0, 0])
        self.deg = self.mesh.padded_triangles - 1
        self.seed = int(config["seed"])

    # -- the random stream ---------------------------------------------
    def generator(self) -> torch.Generator:
        """The tracker's stream, as a fresh tracker seeds it."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        return g

    def draw(self, gen):
        """One step's numbers, in the tracker's order: e1, e2 (P, 6),
        then the resampling uniform (none when it never resamples)."""
        e1 = torch.randn((self.P, 6), generator=gen, device=self.device)
        e2 = torch.randn((self.P, 6), generator=gen, device=self.device)
        u = (torch.rand((), generator=gen, device=self.device)
             if self.max_kl < NEVER_RESAMPLE_KL else None)
        return e1, e2, u

    # -- beliefs ---------------------------------------------------------
    def initial(self, pose_model) -> Belief:
        """All particles at the model-frame pose, zero velocity, uniform
        weights, every pixel at the initial occlusion probability."""
        pose = torch.as_tensor(np.asarray(pose_model, np.float32),
                               device=self.device).reshape(1, 7)
        pc = scene.to_center_frame(pose, self.mesh.center)
        states = torch.zeros((self.P, 1, 13), device=self.device)
        states[..., :7] = pc[None]
        p0 = float(self.config["observation"]["initial_occlusion_prob"])
        return Belief(states, torch.zeros((self.P,), device=self.device),
                      torch.full((self.P, self.N), p0, device=self.device),
                      torch.zeros((self.N,), device=self.device))

    def from_program(self, states, log_weights, occlusion) -> Belief:
        """A belief held in the tracker's layout (its leaf: the
        pixel-major (n_pad, p_pad) map, with or without (n_pad,) ages),
        copied into the reference's, values unchanged (float32)."""
        q, age = (occlusion if isinstance(occlusion, (tuple, list))
                  else (occlusion, None))
        occ = q[:self.N, :self.P].float().T.contiguous()
        age = (torch.zeros((self.N,), device=self.device) if age is None
               else age[:self.N].float().clone())
        return Belief(states.float().clone(), log_weights.float().clone(),
                      occ, age)

    # -- the step ----------------------------------------------------------
    def candidates(self, states):
        """(N, C) candidate triangle ids at the particles' unweighted mean
        pose; misses name the degenerate last triangle."""
        ref = se3.states_mean(states[:, 0])[:7]
        _, ids = deferred.raycast_ids(self.mesh, ref, self.camera.rays)
        cand = deferred.candidate_ids(ids, self.camera.height,
                                      self.camera.width, self.radius,
                                      self.num_candidates)
        return torch.where(cand >= 0, cand, self.deg)

    def candidate_counts(self, pose_model):
        """(n_active, n_uniq) of the candidate table at one model-frame
        pose: the pixels with a candidate triangle, and the distinct ids
        in the table (the degenerate one among them)."""
        pose = torch.as_tensor(np.asarray(pose_model, np.float32),
                               device=self.device).reshape(1, 7)
        states = torch.zeros((1, 1, 13), device=self.device)
        states[..., :7] = scene.to_center_frame(pose, self.mesh.center)
        cand = self.candidates(states)
        return (int(torch.any(cand != self.deg, dim=1).sum()),
                int(torch.unique(cand).numel()))

    def triangle_slack(self, states):
        if self.fixed_slack is not None:
            return float(self.fixed_slack)
        zbar = slack.cloud_depth(states[..., 0, 2])
        return slack.auto_bary_slack(zbar, 1.0 / self.fx, self.med_edge,
                                     self.slack_px)

    def sense(self, states, occ, age, z, dtf):
        """(loglik (P,), occlusion posterior (P, N)) of ``states`` on the
        flat frame ``z``."""
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

        cand = self.candidates(states)                       # (N, C)
        active = torch.any(cand != self.deg, dim=1)
        act = torch.nonzero(active)[:, 0]
        sl = self.triangle_slack(states)
        G, t_num = raycast.pose_tri_constants(self.mesh, states[:, 0, :7])

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
            sa = sl * adet
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

    def step(self, bel: Belief, z, dt, draws, dtype: str = "float32"):
        """One step of ``bel`` on the frame ``z`` over ``dt`` seconds with
        ``draws`` (:meth:`draw`), computed in ``dtype`` (``float32`` or
        the control's ``tf32``)."""
        with precision(dtype):
            return self._step(bel, z, dt, draws)

    def _step(self, bel: Belief, z, dt, draws) -> Step:
        e1, e2, u = draws
        z = scene.preprocess(torch.as_tensor(z, device=self.device))
        dt_t = torch.full((), float(np.float32(dt)), dtype=torch.float32,
                          device=self.device)
        dtf = dt_t * float(np.float32(self.frame_rate))
        states = bel.states.clone()
        states[:, 0] = sample_transition(bel.states[:, 0], dt_t, self.trans,
                                         e1=e1, e2=e2)
        loglik, post = self.sense(states, bel.occ, bel.age, z, dtf)
        log_w = bel.log_weights + loglik
        kl = rs.kl_to_uniform(log_w)
        kl_f = float(kl)

        def branch(do):
            if do:
                idx = rs.systematic_indices(log_w, self.P, u=u)
                idx = idx.clamp(0, self.P - 1)
                return (states.index_select(0, idx), post.index_select(0, idx),
                        torch.zeros_like(log_w))
            return states, post, log_w

        def summary(st, lw):
            ln, _ = rs.normalize_log_weights(lw)
            w = torch.exp(ln)
            ms = se3.states_mean(st, w)                      # (1, 13)
            return ms, torch.sum(w * loglik)

        resamples = self.max_kl < NEVER_RESAMPLE_KL
        do = resamples and kl_f > self.max_kl
        st, oc, lw = branch(do)
        ms, ml = summary(st, lw)
        other = st_o = ms_o = None
        if resamples and abs(kl_f - self.max_kl) <= KL_AMBIGUITY * max(
                1.0, self.max_kl):
            st_o, _, lw_o = branch(not do)
            ms_o, _ = summary(st_o, lw_o)
            other = scene.to_model_frame(ms_o[:, :7], self.mesh.center)
        new = Belief(st, lw, oc, torch.zeros_like(bel.age))
        return Step(new, ms, scene.to_model_frame(ms[:, :7], self.mesh.center),
                    ml, kl_f, bool(do), other, st_o, ms_o)


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
    """The median over particles of the position gap (m) between two sets
    of particle states (P, K, 13) in the same order: one particle whose
    resampling parent went the other way by rounding moves no median."""
    d = states[..., :3].double() - want[..., :3].double()
    return float(torch.linalg.norm(d, dim=-1).reshape(-1).median())


def weighted_mean_state(states, log_weights):
    """The weighted mean state (K, 13) of particles."""
    ln, _ = rs.normalize_log_weights(log_weights.float())
    return se3.states_mean(states.float(), torch.exp(ln))


def weighted_mean_pose(ref: ParticleReference, states, log_weights):
    """The model-frame weighted mean pose (1, 7) of particles."""
    ms = weighted_mean_state(states, log_weights)
    return scene.to_model_frame(ms[:, :7], ref.mesh.center)

