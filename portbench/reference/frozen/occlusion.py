"""Frozen copy of ``dbot_ros_tpu_torch/models/occlusion.py`` (commit 8da1569), with its
imports pointed at the other frozen copies beside it. The benchmark's
reference computes with it; it imports nothing of the port, so later
changes to the port cannot move the yardstick.

The original docstring follows.

Per-pixel occlusion as a 2-state Markov chain, filtered analytically.

Port of ``dbot_ros_tpu/models/occlusion.py``. With stationary probability
``pi = p_ov / (1 - g)`` and spectral factor ``g = p_oo - p_ov`` the chain
propagates in closed form, ``p_t = pi + g^t (p_0 - pi)``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OcclusionParams:
    """Occlusion chain parameters (per unit frame interval), 0-d float32."""

    p_occluded_visible: torch.Tensor
    p_occluded_occluded: torch.Tensor
    initial_occlusion_prob: torch.Tensor


def make_occlusion_params(p_occluded_visible=0.1,
                          p_occluded_occluded=0.7,
                          initial_occlusion_prob=0.1,
                          device=None) -> OcclusionParams:
    def f(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return OcclusionParams(f(p_occluded_visible), f(p_occluded_occluded),
                           f(initial_occlusion_prob))


def propagate(p_occ, params: OcclusionParams, dt_frames=1.0):
    """Propagate occlusion probabilities over ``dt_frames`` frame intervals."""
    g = params.p_occluded_occluded - params.p_occluded_visible
    pi = params.p_occluded_visible / torch.clamp_min(1.0 - g, 1e-12)
    gdt = torch.sign(g) * torch.pow(torch.abs(g), dt_frames)
    return torch.clamp(pi + gdt * (p_occ - pi), 0.0, 1.0)


def stationary(params: OcclusionParams):
    g = params.p_occluded_occluded - params.p_occluded_visible
    return params.p_occluded_visible / torch.clamp_min(1.0 - g, 1e-12)
