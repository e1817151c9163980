"""Image log-likelihood with analytic per-pixel occlusion filtering.

Port of ``dbot_ros_tpu/models/image_loglik.py``: given per-particle
predicted depths and the observed frame, each particle's log-likelihood
and the per-pixel occlusion posterior (Rao-Blackwellization, Wüthrich
IROS 2013 §IV), in the particle-major ``(P, N)`` occlusion layout.

Per pixel with propagated occlusion prior ``q`` and predicted depth ``d``:

    on-silhouette (d finite):
        p(z) = (1-q)·p_vis(z|d) + q·p_occ(z|d)
        q'   = q·p_occ(z|d) / p(z)
    off-silhouette (d = inf):
        p(z) = p_bg(z)          q' = q
    invalid z (NaN): densities replaced by the invalid point masses.

This is the everything-after-render step of the ``"xla"`` sensor, the
initializer's scoring pass and the island trial's pose score; the fused
sensor (ops/fused_sensor.py) computes the same inside its kernel.
"""

from __future__ import annotations

import torch

from dbot_ros_tpu_torch.models import beam as beam_mod
from dbot_ros_tpu_torch.models import occlusion as occ_mod

_TINY = 1e-30


def pixel_likelihoods(depth_pred, z_obs, occ_prior,
                      bp: beam_mod.BeamParams):
    """Per-pixel likelihood + occlusion posterior (all shapes broadcast).

    Args:
      depth_pred: predicted depths, inf = off-silhouette. [..., N]
      z_obs: observed depths, NaN = invalid return. [N] (broadcasts)
      occ_prior: propagated occlusion probabilities. [..., N]
    Returns:
      (p_z, occ_post): per-pixel marginal likelihood and posterior.
    """
    z_valid = torch.isfinite(z_obs)
    z = torch.where(z_valid, z_obs, 1.0)  # safe placeholder, masked below
    on_sil = torch.isfinite(depth_pred)
    d = torch.where(on_sil, depth_pred, 1.0)

    lik_vis = torch.where(z_valid, beam_mod.density_visible(z, d, bp),
                          bp.p_invalid_visible)
    lik_occ = torch.where(z_valid, beam_mod.density_occluded(z, d, bp),
                          bp.p_invalid_occluded)
    lik_bg = torch.where(z_valid, beam_mod.density_background(z, bp),
                         bp.p_invalid_background)

    p_on = (1.0 - occ_prior) * lik_vis + occ_prior * lik_occ
    p_z = torch.where(on_sil, p_on, lik_bg)

    occ_post = occ_prior * lik_occ / torch.clamp_min(p_on, _TINY)
    occ_post = torch.where(on_sil, torch.clamp(occ_post, 0.0, 1.0),
                           occ_prior)
    return torch.clamp_min(p_z, _TINY), occ_post


def image_loglik(depth_pred, z_obs, occ_prob, bp: beam_mod.BeamParams,
                 op: occ_mod.OcclusionParams, dt_frames=1.0):
    """Log-likelihood per particle + updated occlusion map.

    Args:
      depth_pred: [..., N] rendered depths (inf = miss).
      z_obs: [N] observed frame (NaN = invalid).
      occ_prob: [..., N] occlusion probabilities from the previous frame.
    Returns:
      (loglik [...], occ_post [..., N])
    """
    occ_prior = occ_mod.propagate(occ_prob, op, dt_frames)
    p_z, occ_post = pixel_likelihoods(depth_pred, z_obs, occ_prior, bp)
    return torch.sum(torch.log(p_z), dim=-1), occ_post
