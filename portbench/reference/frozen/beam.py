"""Frozen copy of ``dbot_ros_tpu_torch/models/beam.py`` (commit 8da1569), with its
imports pointed at the other frozen copies beside it. The benchmark's
reference computes with it; it imports nothing of the port, so later
changes to the port cannot move the yardstick.

The original docstring follows.

Occlusion-aware beam model for a single depth pixel.

Port of ``dbot_ros_tpu/models/beam.py`` (Wüthrich et al., IROS 2013,
§IV-B): visible (truncated Gaussian around the predicted depth d with
sigma(d) = model_sigma + sigma_factor·d²), occluded (truncated exponential
over [z_min, d]), uniform clutter with weight ``tail_weight``, and NaN
point masses per state. Outputs are linear densities.

The fused sensor (ops/fused_sensor.py and its kernel) uses the same
parameters with the truncation normalizer taken as 1.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_SQRT2PI = 2.5066282746310002


@dataclasses.dataclass(frozen=True)
class BeamParams:
    """0-d float32 tensors (reference YAML names)."""

    tail_weight: torch.Tensor        # clutter mixture weight
    model_sigma: torch.Tensor        # base depth noise [m]
    sigma_factor: torch.Tensor       # quadratic range-noise coefficient [1/m]
    min_depth: torch.Tensor          # sensor minimum range [m]
    max_depth: torch.Tensor          # sensor maximum range [m]
    exponential_rate: torch.Tensor   # occluder density rate [1/m]
    p_invalid_occluded: torch.Tensor  # P(NaN | occluded)
    p_invalid_visible: torch.Tensor   # P(NaN | visible)
    p_invalid_background: torch.Tensor  # P(NaN | off-silhouette)


def make_beam_params(tail_weight=0.02, model_sigma=0.003, sigma_factor=0.0014,
                     min_depth=0.4, max_depth=5.0, exponential_rate=1.5,
                     p_invalid_occluded=0.1, p_invalid_visible=0.01,
                     p_invalid_background=0.3, device=None) -> BeamParams:
    def f(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return BeamParams(f(tail_weight), f(model_sigma), f(sigma_factor),
                      f(min_depth), f(max_depth), f(exponential_rate),
                      f(p_invalid_occluded), f(p_invalid_visible),
                      f(p_invalid_background))


def depth_sigma(d, p: BeamParams):
    """Range-dependent measurement noise sigma(d)."""
    return p.model_sigma + p.sigma_factor * d * d


def _norm_cdf(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def density_visible(z, d, p: BeamParams):
    """p(z | predicted depth d, visible), truncated-Gaussian body + tail."""
    sig = depth_sigma(d, p)
    zn = (z - d) / sig
    body = torch.exp(-0.5 * zn * zn) / (sig * _SQRT2PI)
    norm = (_norm_cdf((p.max_depth - d) / sig)
            - _norm_cdf((p.min_depth - d) / sig))
    body = body / torch.clamp_min(norm, 1e-6)
    tail = 1.0 / (p.max_depth - p.min_depth)
    dens = (1.0 - p.tail_weight) * body + p.tail_weight * tail
    in_range = (z >= p.min_depth) & (z <= p.max_depth)
    return torch.where(in_range, dens * (1.0 - p.p_invalid_visible), 0.0)


def density_occluded(z, d, p: BeamParams):
    """p(z | predicted depth d, occluded): truncated Exp on [z_min, d]
    plus tail."""
    lam = p.exponential_rate
    d_eff = torch.minimum(torch.maximum(d, p.min_depth), p.max_depth)
    span = torch.clamp_min(d_eff - p.min_depth, 1e-6)
    norm = 1.0 - torch.exp(-lam * span)
    body = lam * torch.exp(-lam * (z - p.min_depth)) / torch.clamp_min(
        norm, 1e-6)
    tail = 1.0 / (p.max_depth - p.min_depth)
    in_front = (z >= p.min_depth) & (z <= d_eff)
    in_range = (z >= p.min_depth) & (z <= p.max_depth)
    dens = ((1.0 - p.tail_weight) * torch.where(in_front, body, 0.0)
            + p.tail_weight * torch.where(in_range, tail, 0.0))
    return dens * (1.0 - p.p_invalid_occluded)


def density_background(z, p: BeamParams):
    """p(z) for off-silhouette pixels: uniform clutter over the range."""
    in_range = (z >= p.min_depth) & (z <= p.max_depth)
    tail = 1.0 / (p.max_depth - p.min_depth)
    return torch.where(in_range, tail, 0.0) * (1.0 - p.p_invalid_background)


def mass_invalid(p: BeamParams):
    """(P(NaN|occ), P(NaN|vis), P(NaN|background)) point masses."""
    return p.p_invalid_occluded, p.p_invalid_visible, p.p_invalid_background
