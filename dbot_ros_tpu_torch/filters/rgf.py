"""Robust multi-sensor Gaussian filter on SE(3) (the second estimator).

Port of ``dbot_ros_tpu/filters/rgf.py`` (Issac et al., ICRA 2016): every
(downsampled) depth pixel is an independent scalar sensor; the update is
a sigma-point statistical linearization with per-pixel robustification,
done as one joint information-form update over all pixels:

    Λ' = P⁻¹ + Σ_c H_cᵀ diag(1/R̂_c) H_c     (channels c; H = P_xyᵀ P_lin⁻¹)
    δμ = Λ'⁻¹ Σ_c H_cᵀ diag(1/R̂_c) ν_c      (iterated, trust-region-clipped)

What the update is built from (see ``update``):
  1. Two measurement channels per pixel: hit-conditional surface *depth*
     and the *silhouette* (hit indicator), which keeps lateral pose
     observable.
  2. A learned per-pixel background depth map closes the generative
     model: each observed depth is assigned to {object, background,
     occluder/clutter}; the responsibilities weight the channels.
  3. A floor and a cap on the linearization spread (never on the belief).
  4. An iterated update with trust-region steps, since the render is
     discontinuous in the pose.
  5. Temporal occlusion memory: the per-pixel clutter prior is an
     occlusion chain over the pixel's own responsibility history.

The render is an argument (``render_fn``): the sigma states go through
ops/raycast or ops/deferred like a tiny particle batch.

The small dense linear algebra (12K × 12K) goes through
``torch.linalg.inv_ex`` / ``solve_ex`` / ``cholesky_ex`` with
``check_errors=False``: a singular matrix gives non-finite values, as in
the reference, and no status is copied back to the host. Nothing in a
step reads a value back, and nothing writes a belief's tensors in place
(the beliefs of a hypothesis trial share their background map).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from dbot_ros_tpu_torch.models import beam as beam_mod
from dbot_ros_tpu_torch.models import occlusion as occ_mod
from dbot_ros_tpu_torch.models.transition import (TransitionParams,
                                                  process_noise_cov,
                                                  transition_mean)
from dbot_ros_tpu_torch.ops import sigma_points as sp
from dbot_ros_tpu_torch.utils import se3


@dataclasses.dataclass(frozen=True)
class GaussianBelief:
    """Gaussian belief: mean state (13,) + tangent covariance (12, 12), or
    (K, 13) and (12K, 12K) for a K-object scene.

    ``background`` is a per-pixel scene-depth estimate (N,) learned online
    from pixels the object does not cover: sigma points whose ray misses
    the object predict the background depth. ``occ_prior`` is the
    optional per-pixel occlusion-probability memory (None: the
    instantaneous per-frame mixture only). The belief carries no random
    state: the filter is deterministic.
    """

    mean: torch.Tensor
    cov: torch.Tensor
    background: torch.Tensor
    occ_prior: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class RgfStepInfo:
    mean_state: torch.Tensor      # (13,) | (K, 13)
    mean_beta: torch.Tensor       # average body responsibility (inlier rate)
    innovation_rms: torch.Tensor  # RMS depth innovation over inlier pixels
    # per-frame observation log-marginal Σ_px log p(y_px | belief) at the
    # converged mean: the evidence a multi-hypothesis trial races
    obs_loglik: torch.Tensor


def init_belief(initial_pose, num_pixels: int = 0, first_frame=None,
                pos_sigma=0.02, rot_sigma=0.1, vel_sigma=0.1,
                background_depth=5.0, initial_occlusion_prob=None,
                device=None) -> GaussianBelief:
    """Gaussian init around the given pose(s).

    ``initial_pose`` (7,) → single-object belief (mean (13,), cov 12×12);
    (K, 7) → scene belief (mean (K, 13), joint block-diagonal cov).

    The background map starts from ``first_frame`` where finite (a depth
    frame taken at or before initialization), else at
    ``background_depth``; it keeps learning online during tracking.
    Tensors go to ``device`` (default: ``initial_pose``'s).
    """
    initial_pose = torch.as_tensor(initial_pose, dtype=torch.float32,
                                   device=device)
    dev = initial_pose.device
    K = initial_pose.shape[0] if initial_pose.ndim == 2 else 1
    mean = torch.cat([initial_pose, initial_pose.new_zeros(
        initial_pose.shape[:-1] + (6,))], dim=-1)
    diag = torch.tensor(([pos_sigma ** 2] * 3 + [rot_sigma ** 2] * 3
                         + [vel_sigma ** 2] * 6) * K, dtype=torch.float32,
                        device=dev)
    if first_frame is not None:
        first_frame = torch.as_tensor(first_frame, dtype=torch.float32,
                                      device=dev)
        bg = torch.where(torch.isfinite(first_frame), first_frame,
                         float(background_depth))
    else:
        bg = torch.full((num_pixels,), float(background_depth), device=dev)
    occ_prior = (None if initial_occlusion_prob is None else
                 torch.full_like(bg, float(initial_occlusion_prob)))
    return GaussianBelief(mean=mean, cov=torch.diag(diag), background=bg,
                          occ_prior=occ_prior)


def _scene_mean(mean):
    """Normalize (13,) | (K, 13) → ((K, 13), was_single)."""
    single = mean.ndim == 1
    return (mean[None] if single else mean), single


def predict(belief: GaussianBelief, dt, params: TransitionParams,
            ut=None) -> GaussianBelief:
    """UKF prediction through the damped-Wiener dynamics.

    Works on single-object beliefs (mean (13,), cov 12×12) and K-object
    scene beliefs (mean (K, 13), cov 12K×12K: joint tangent space, process
    noise block-diagonal per object). ``dt`` is a Python float or a 0-d
    tensor."""
    ut = ut or sp.default_ut_params()
    mean0, single = _scene_mean(belief.mean)
    K = mean0.shape[0]
    states, _, wm, wc = sp.scene_sigma_points(mean0, belief.cov, **ut)
    prop = transition_mean(states, dt, params)
    mean, cov, _ = sp.scene_reconstruct_moments(prop, prop[0], wm, wc)
    Q = process_noise_cov(dt, params, cov.dtype)
    cov = cov + (Q if K == 1 else torch.block_diag(*([Q] * K)))
    return GaussianBelief(mean=mean[0] if single else mean, cov=cov,
                          background=belief.background,
                          occ_prior=belief.occ_prior)


def _gauss(y, m, var):
    var = torch.clamp_min(var, 1e-12)
    d = y - m
    return torch.exp(-0.5 * d * d / var) / torch.sqrt(2.0 * math.pi * var)


def _occluder_tail(y, front, bp):
    """Clutter density: uniform + truncated exponential in front of the
    expected scene surface (the shape of the beam model's occluded
    branch, models/beam.py density_occluded)."""
    uniform = 1.0 / (bp.max_depth - bp.min_depth)
    lam = bp.exponential_rate
    span = torch.clamp_min(
        torch.minimum(torch.maximum(front, bp.min_depth), bp.max_depth)
        - bp.min_depth, 1e-6)
    norm = torch.clamp_min(1.0 - torch.exp(-lam * span), 1e-6)
    in_front = (y >= bp.min_depth) & (y <= front)
    exp_dens = torch.where(
        in_front, lam * torch.exp(-lam * (y - bp.min_depth)) / norm, 0.0)
    return 0.5 * uniform + 0.5 * exp_dens


@functools.lru_cache(maxsize=32)
def _probe_cap(K, lin_cap_pos, lin_cap_rot, device):
    """(12K,) cap of the probe's marginal stds: positions, rotations,
    velocities unbounded. Built once per configuration and device."""
    return torch.tensor(([lin_cap_pos] * 3 + [lin_cap_rot] * 3
                         + [math.inf] * 6) * K, dtype=torch.float32,
                        device=device)


def update(belief: GaussianBelief, z_obs, render_fn,
           bp: beam_mod.BeamParams, ut=None, iterations: int = 3,
           trust_sigma: float = 1.0, lin_floor_pos: float = 0.008,
           lin_floor_rot: float = 0.04, lin_cap_pos: float = 0.04,
           lin_cap_rot: float = 0.25, bg_sigma: float = 0.02,
           invalid_discount: float = 0.25, occ_params=None,
           occ_dt_frames=1.0, learn_world: bool = True):
    """Robust multi-sensor measurement update (see the module docstring).

    * Depth moments are *hit-conditional* and silhouette information
      flows through its own indicator channel: folding misses into the
      depth moments poisons the linearization.
    * An occluder explains measurements in front of the expected surface;
      such pixels get r_obj ≈ r_bg ≈ 0 and inform neither channel, so a
      transient occluder neither drags the pose nor poisons the
      background map (which also learns slowly, EMA 0.2).
    * ``learn_world=False`` freezes the background map and the occlusion
      memory (a multi-hypothesis trial must not let each wrong hypothesis
      adapt its own world to its misfit): both come back as the very
      tensors that went in.

    Args:
      render_fn: poses (S, 7) → predicted depths (S, N) for single-object
        beliefs; poses (S, K, 7) → (S, N) (min over objects) for scene
        beliefs; inf = miss.
      occ_dt_frames: frame intervals since the last update (a float or a
        0-d tensor), for the occlusion memory.
    """
    ut = ut or sp.default_ut_params()
    mean0, single = _scene_mean(belief.mean)
    K = mean0.shape[0]
    D = 12 * K
    dev, dtype = belief.cov.device, belief.cov.dtype
    eye = torch.eye(D, dtype=dtype, device=dev)
    P = belief.cov + 1e-10 * eye
    P_inv = torch.linalg.inv_ex(P, check_errors=False).inverse

    # Linearization-spread cap: a prediction over a long frame gap
    # inflates P far past the object's pixel footprint, and a statistical
    # linearization probed over tens of centimetres is meaningless. Cap
    # the probe (and with it the per-step trust radius) at lin_cap_*;
    # reach beyond the cap comes from the iterated re-renders. The belief
    # covariance itself is not capped. Diagonal scaling S P S keeps the
    # probe PSD.
    cap_full = _probe_cap(K, float(lin_cap_pos), float(lin_cap_rot), dev)
    scale = torch.clamp_max(
        cap_full / torch.clamp_min(torch.sqrt(torch.diagonal(P)), 1e-12),
        1.0)
    P_probe = P * scale[:, None] * scale[None, :]
    step_cap = trust_sigma * torch.sqrt(torch.diagonal(P_probe))
    bg = belief.background
    bg_sigma_sq = float(bg_sigma) ** 2

    # Temporal occlusion memory: the per-pixel clutter/occluder prior is
    # the chain-propagated occlusion probability instead of the flat
    # tail_weight.
    if belief.occ_prior is not None and occ_params is not None:
        occ_pred = occ_mod.propagate(belief.occ_prior, occ_params,
                                     occ_dt_frames)
        w_c = torch.clamp_max(torch.maximum(occ_pred, bp.tail_weight), 0.95)
    else:
        occ_pred = None
        w_c = bp.tail_weight

    # Linearization-spread floor: once the belief contracts below one
    # pixel's metric size, all sigma points agree on every pixel and the
    # silhouette gradient vanishes. Widening only the linearization
    # covariance keeps edges observable. The floor anneals with the
    # belief: ~1.5× the current marginal std per block, clamped to
    # [¼·floor, floor].
    diagP = torch.diagonal(P_probe).reshape(K, 12)
    pos_std = torch.sqrt(torch.mean(diagP[:, 0:3], dim=-1))
    rot_std = torch.sqrt(torch.mean(diagP[:, 3:6], dim=-1))
    fp = torch.clamp(1.5 * pos_std, 0.25 * lin_floor_pos, lin_floor_pos)
    fr = torch.clamp(1.5 * rot_std, 0.25 * lin_floor_rot, lin_floor_rot)
    floor = torch.cat([(fp ** 2)[:, None].expand(K, 3),
                       (fr ** 2)[:, None].expand(K, 3),
                       fp.new_zeros((K, 6))], dim=1).reshape(-1)
    P_lin = P_probe + torch.diag(floor)

    valid = torch.isfinite(z_obs) & (z_obs >= bp.min_depth) \
        & (z_obs <= bp.max_depth)
    y = torch.where(valid, z_obs, 1.0)
    validf = valid.to(dtype)
    # A mostly-invalid frame signals sensor failure, not object absence:
    # the invalid pixels' silhouette information scales with the frame's
    # valid fraction, so an all-invalid frame contributes nothing.
    invalid_weight = invalid_discount * torch.mean(validf)

    def linearize(mean):
        """Two measurement channels per pixel from one sigma-point render:
        the object's surface depth conditional on the ray hitting it, and
        the hit indicator itself. A per-pixel generative mixture assigns
        the observed depth to {object body, background, occluder or
        clutter}; the responsibilities weight the channels."""
        states, deltas, wm, wc = sp.scene_sigma_points(mean, P_lin, **ut)
        poses = states[:, 0, :7] if single else states[..., :7]
        Y_raw = render_fn(poses)                        # (S, N)
        hit = torch.isfinite(Y_raw)
        hitf = hit.to(dtype)
        Y = torch.where(hit, Y_raw, 0.0)

        # --- hit-conditional depth moments
        wm_hit = wm[:, None] * hitf                     # (S, N)
        p_hit = torch.sum(wm_hit, dim=0)                # (N,)
        safe_p = torch.clamp_min(p_hit, 1e-6)
        m = torch.sum(wm_hit * Y, dim=0) / safe_p
        Yc = torch.where(hit, Y - m[None, :], 0.0)
        wYc = wm_hit * Yc
        s_yy = torch.sum(wYc * Yc, dim=0) / safe_p
        Pxy_d = (deltas.T @ wYc) / safe_p               # (D, N)

        # --- silhouette (hit-indicator) moments
        hc = hitf - p_hit[None, :]
        Pxy_s = (deltas * wm[:, None]).T @ hc           # (D, N)

        # --- generative mixture responsibilities at the observed depth.
        # Invalid pixels use the beam model's invalid point masses: a
        # miss is informative (P(invalid | visible) ≪ P(invalid |
        # off-object)), so a pixel where the belief predicts object but
        # the sensor sees nothing exerts a silhouette shrink force.
        R = beam_mod.depth_sigma(m, bp) ** 2
        prior_obj = p_hit * (1.0 - w_c)
        prior_bg = (1.0 - p_hit) * (1.0 - w_c)
        c_obj = torch.where(valid, prior_obj * _gauss(y, m, s_yy + R),
                            prior_obj * bp.p_invalid_visible)
        c_bg = torch.where(valid,
                           prior_bg * _gauss(y, bg, bg_sigma_sq + R),
                           prior_bg * bp.p_invalid_background)
        front = p_hit * m + (1.0 - p_hit) * bg
        c_clut = torch.where(valid, w_c * _occluder_tail(y, front, bp),
                             w_c * bp.p_invalid_occluded)
        total = torch.clamp_min(c_obj + c_bg + c_clut, 1e-30)
        obs_ll = torch.sum(torch.log(total))
        r_obj = c_obj / total
        r_bg = c_bg / total

        # both channels' gains from one factorization of P_lin
        H = torch.linalg.solve_ex(P_lin, torch.cat([Pxy_d, Pxy_s], dim=1),
                                  check_errors=False).result
        N = Pxy_d.shape[1]
        H_d, H_s = H[:, :N].T, H[:, N:].T               # (N, D) each

        # --- depth channel: only measured on valid returns
        expl_d = torch.sum(H_d * Pxy_d.T, dim=1)
        U_d = torch.clamp_min(s_yy - expl_d, 0.0)
        iR_d = torch.where(valid, r_obj, 0.0) / (R + U_d + 1e-12)
        innov_d = torch.where(valid, y - m, 0.0)

        # --- silhouette channel: observed foreground fraction vs p_hit.
        # Invalid pixels take part through the invalid point masses,
        # tempered (they are spatially correlated).
        o_obs = r_obj / torch.clamp_min(r_obj + r_bg, 1e-6)
        var_s = p_hit * (1.0 - p_hit) + 0.05
        iR_s = torch.where(valid, 1.0, invalid_weight) \
            * (r_obj + r_bg) / var_s
        innov_s = o_obs - p_hit

        return ((H_d, iR_d, innov_d), (H_s, iR_s, innov_s),
                r_obj, r_bg, p_hit, obs_ll)

    def information(channels):
        Lam = P_inv
        rhs = torch.zeros((D,), dtype=dtype, device=dev)
        for H, iR, innov in channels:
            Ht_iR = H.T * iR[None, :]                   # (D, N)
            Lam = Lam + Ht_iR @ H
            rhs = rhs + Ht_iR @ innov
        return 0.5 * (Lam + Lam.T), rhs

    # Iterated statistically-linearized update: re-render at the running
    # mean; each tangent step is clipped to the probe's sigma ellipsoid.
    # The cumulative displacement from the prior mean is also clipped,
    # with a radius gated on occluder evidence: when predicted-object
    # pixels are explained by the occluder tail the radius contracts to
    # about one trust step, so a visible fragment cannot drag the mean
    # iterations × trust_sigma sigmas in one frame.
    mean = mean0
    chans = r_obj = r_bg = p_hit = obs_ll = None
    for _ in range(iterations):
        chan_d, chan_s, r_obj, r_bg, p_hit, obs_ll = linearize(mean)
        chans = (chan_d, chan_s)
        on_obj_f = (p_hit > 0.5).to(dtype)
        r_clut = 1.0 - r_obj - r_bg
        occ_frac = torch.sum(r_clut * on_obj_f) / torch.clamp_min(
            torch.sum(on_obj_f), 1.0)
        gate = (1.0 - occ_frac) ** 2
        total_cap = step_cap * (1.0 + (iterations - 1.0) * gate)
        Lam, rhs = information(chans)
        # Gauss-Newton step around the current mean: account for the
        # displacement already taken from the prior mean.
        d0 = se3.state_boxminus(mean, mean0).reshape(-1)
        delta = torch.linalg.solve_ex(Lam, (rhs - P_inv @ d0)[:, None],
                                      check_errors=False).result[:, 0]
        delta = torch.minimum(torch.maximum(delta, -step_cap), step_cap)
        # The plain iterate is retracted from the current mean; only when
        # the cumulative displacement exceeds the gated radius is it
        # pulled back onto the trust boundary around the prior mean.
        cand = se3.state_boxplus(mean, delta.reshape(K, 12))
        d_tot = se3.state_boxminus(cand, mean0).reshape(-1)
        exceeded = torch.any(torch.abs(d_tot) > total_cap)
        capped = se3.state_boxplus(
            mean0, torch.minimum(torch.maximum(d_tot, -total_cap),
                                 total_cap).reshape(K, 12))
        mean = torch.where(exceeded, capped, cand)

    Lam, _ = information(chans)
    cov_new = torch.linalg.inv_ex(Lam, check_errors=False).inverse
    cov_new = 0.5 * (cov_new + cov_new.T)

    # Learn the background where the object (almost surely) is not, at a
    # deliberately slow rate (EMA 0.2).
    if learn_world:
        finite = torch.isfinite(z_obs)
        learn = (p_hit < 0.05) & finite
        bg_new = torch.where(
            learn, 0.8 * bg + 0.2 * torch.where(finite, z_obs, bg), bg)
    else:
        bg_new = bg

    occ_prior_new = belief.occ_prior
    if occ_pred is not None and learn_world:
        # the responsibilities are informative on invalid pixels too: the
        # chain accumulates everywhere
        occ_prior_new = torch.clamp(1.0 - r_obj - r_bg, 0.0, 1.0)

    mean_out = mean[0] if single else mean
    nb = GaussianBelief(mean=mean_out, cov=cov_new, background=bg_new,
                        occ_prior=occ_prior_new)
    innov_d = chans[0][2]
    w = r_obj / torch.clamp_min(torch.sum(r_obj), 1e-6)
    # mean object-responsibility over pixels the belief expects to be
    # object: the inlier-rate diagnostic (drops under occlusion)
    on_obj_f = (p_hit > 0.5).to(dtype)
    info = RgfStepInfo(
        mean_state=mean_out,
        mean_beta=torch.sum(r_obj * on_obj_f) / torch.clamp_min(
            torch.sum(on_obj_f), 1.0),
        innovation_rms=torch.sqrt(torch.sum(w * innov_d * innov_d)),
        obs_loglik=obs_ll)
    return nb, info


def rgf_step(belief: GaussianBelief, z_obs, render_fn, trans_params, dt,
             bp: beam_mod.BeamParams, ut=None, **update_kwargs):
    """predict ∘ update: one frame."""
    belief = predict(belief, dt, trans_params, ut)
    return update(belief, z_obs, render_fn, bp, ut, **update_kwargs)


_BELIEF_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianBelief))
_INFO_FIELDS = tuple(f.name for f in dataclasses.fields(RgfStepInfo))


def make_batched_step(render_fn, trans_params, dt,
                      bp: beam_mod.BeamParams, ut=None, **update_kwargs):
    """Multi-scene step: ``rgf_step`` mapped over a leading scene axis
    with ``torch.func.vmap``.

    Beliefs are a stacked ``GaussianBelief`` (every tensor gains a leading
    S axis, see :func:`stack_beliefs`), observations are (S, N). The whole
    step is plain tensor code with no host read and no data-dependent
    branch, the sigma renders included, so one card serves S independent
    streams with one sequence of launches.

    Returns ``step(beliefs, z_obs) → (beliefs', infos)``.
    """
    def step(beliefs, z_obs):
        # the fields that are tensors (occ_prior may be None, and then
        # stays None)
        names = [n for n in _BELIEF_FIELDS
                 if getattr(beliefs, n) is not None]

        def one(z, *leaves):
            nb, info = rgf_step(
                GaussianBelief(**dict(zip(names, leaves))), z,
                render_fn=render_fn, trans_params=trans_params, dt=dt,
                bp=bp, ut=ut, **update_kwargs)
            return (tuple(getattr(nb, n) for n in names),
                    tuple(getattr(info, n) for n in _INFO_FIELDS))

        out_b, out_i = torch.func.vmap(one)(
            z_obs, *(getattr(beliefs, n) for n in names))
        return (GaussianBelief(**dict(zip(names, out_b))),
                RgfStepInfo(**dict(zip(_INFO_FIELDS, out_i))))

    return step


def stack_beliefs(beliefs):
    """Stack per-scene GaussianBeliefs into one batched belief."""
    beliefs = list(beliefs)
    return GaussianBelief(**{
        n: (None if getattr(beliefs[0], n) is None
            else torch.stack([getattr(b, n) for b in beliefs]))
        for n in _BELIEF_FIELDS})
