"""Frozen copy of ``dbot_ros_tpu_torch/ops/resample.py`` (commit 8da1569), with its
imports pointed at the other frozen copies beside it. The benchmark's
reference computes with it; it imports nothing of the port, so later
changes to the port cannot move the yardstick.

The original docstring follows.

Particle weight bookkeeping and resampling.

Port of ``dbot_ros_tpu/ops/resample.py``. The functions take unnormalized
*log* weights along the last axis (:func:`weight_cdf` takes weights).
``torch.searchsorted(side="left")`` replaces the reference's TPU-only
blocked-rank search, and :func:`weight_cdf` ``torch.cumsum``, so that the
CDF is the same bits on every call on the card too. Random numbers may be
passed in (``u``) or are drawn from ``generator``.
"""

from __future__ import annotations

import math

import torch


def normalize_log_weights(log_w):
    """Return (normalized log weights, logsumexp) along the last axis."""
    lse = torch.logsumexp(log_w, dim=-1, keepdim=True)
    return log_w - lse, lse[..., 0]


def effective_sample_size(log_w):
    """ESS = 1 / Σ wᵢ² of the normalized weights."""
    ln, _ = normalize_log_weights(log_w)
    return torch.exp(-torch.logsumexp(2.0 * ln, dim=-1))


def kl_to_uniform(log_w):
    """KL(w ‖ uniform) = Σ wᵢ log wᵢ + log N — the resampling trigger."""
    ln, _ = normalize_log_weights(log_w)
    n = log_w.shape[-1]
    w = torch.exp(ln)
    return (torch.sum(w * torch.where(w > 0, ln, 0.0), dim=-1)
            + math.log(float(n)))


def weight_cdf(w):
    """Inclusive cumulative sum of ``w`` along the last axis, the same bits
    on every call.

    On the card, ``torch.cumsum`` of a tensor that is one row (``numel``
    equal to the last axis) is a single-pass scan whose tiles take their
    prefix from whichever earlier tiles have finished: its float32 sums
    are grouped differently from call to call, and a systematic threshold
    within rounding of a CDF step then picks the neighbouring parent. A
    tensor of several rows is scanned a row per thread block, in a fixed
    order. So a single row is scanned beside a copy of itself (on the CPU
    both give the sequential sum)."""
    if w.numel() != w.shape[-1]:
        return torch.cumsum(w, dim=-1)
    two = w.reshape(1, -1).expand(2, -1).contiguous()
    return torch.cumsum(two, dim=-1)[0].reshape(w.shape)


def systematic_indices(log_w, num_samples: int, u=None, generator=None):
    """Systematic (low-variance) resampling → sorted parent indices.

    One uniform ``u`` in [0, 1) (drawn from ``generator`` when not given);
    thresholds (i + u)/M against the weight CDF.
    """
    ln, _ = normalize_log_weights(log_w)
    cdf = weight_cdf(torch.exp(ln))
    if u is None:
        u = torch.rand((), generator=generator, device=log_w.device)
    u = torch.as_tensor(u, dtype=torch.float32, device=log_w.device)
    pos = (torch.arange(num_samples, dtype=torch.float32,
                        device=log_w.device) + u) / num_samples
    idx = torch.searchsorted(cdf, pos, side="left")
    return torch.clamp(idx, 0, log_w.shape[-1] - 1)


def multinomial_indices(log_w, num_samples: int, generator=None):
    """IID categorical resampling."""
    ln, _ = normalize_log_weights(log_w)
    return torch.multinomial(torch.exp(ln), num_samples, replacement=True,
                             generator=generator)
