"""Body-tail observation model for the robust Gaussian filter.

Port of ``dbot_ros_tpu/models/body_tail.py``: each depth pixel's
measurement density is a mixture of a Gaussian *body* around the
predicted depth and a broad *tail* (uniform clutter plus a truncated
exponential in front of the prediction):

    p(y) = w_body · N(y; m, S) + (1 - w_body) · tail(y)

The robustification quantity is the body responsibility
``beta(y) = w_body N(y; m, S) / p(y)``: an outlier pixel (beta → 0)
contributes nothing, a clean pixel (beta → 1) gives the standard
sigma-point update.
"""

from __future__ import annotations

import torch

from dbot_ros_tpu_torch.models.beam import BeamParams

_SQRT2PI = 2.5066282746310002


def body_responsibility(y, m, S, p: BeamParams, body_weight=1.0):
    """beta(y) per pixel; 0 for invalid returns.

    Args:
      y: observed depths [N] (NaN = invalid).
      m: predicted depth mean [..., N].
      S: predicted depth variance incl. sensor noise [..., N].
      body_weight: prior probability the pixel is explained by the body at
        all (e.g. the silhouette hit probability from the sigma points);
        the complement joins the tail mass.
    """
    valid = torch.isfinite(y) & (y >= p.min_depth) & (y <= p.max_depth)
    y_safe = torch.where(valid, y, 1.0)
    sig = torch.sqrt(torch.clamp_min(S, 1e-12))
    zn = (y_safe - m) / sig
    body = torch.exp(-0.5 * zn * zn) / (sig * _SQRT2PI)
    uniform = 1.0 / (p.max_depth - p.min_depth)
    # occluder-aware tail: returns in front of the prediction
    lam = p.exponential_rate
    span = torch.clamp_min(
        torch.minimum(torch.maximum(m, p.min_depth), p.max_depth)
        - p.min_depth, 1e-6)
    exp_norm = 1.0 - torch.exp(-lam * span)
    in_front = (y_safe >= p.min_depth) & (y_safe <= m)
    exp_dens = torch.where(
        in_front,
        lam * torch.exp(-lam * (y_safe - p.min_depth))
        / torch.clamp_min(exp_norm, 1e-6), 0.0)
    tail = 0.5 * uniform + 0.5 * exp_dens
    w_body = body_weight * (1.0 - p.tail_weight)
    num = w_body * body
    den = num + (1.0 - w_body) * tail
    beta = num / torch.clamp_min(den, 1e-30)
    return torch.where(valid, beta, 0.0)
