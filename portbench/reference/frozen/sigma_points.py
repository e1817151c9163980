"""Frozen copy of ``dbot_ros_tpu_torch/ops/sigma_points.py`` (commit 8da1569), with its
imports pointed at the other frozen copies beside it. The benchmark's
reference computes with it; it imports nothing of the port, so later
changes to the port cannot move the yardstick.

The original docstring follows.

Unscented (sigma-point) transform on the SE(3) state manifold.

Port of ``dbot_ros_tpu/ops/sigma_points.py``: sigma points are generated
in the 12-dim tangent space of the 13-dim pose-velocity state (utils/se3
boxplus/boxminus), so the quaternion stays on the manifold. The 2n+1
sigma points ride a leading axis that downstream code treats like a small
particle axis.

The Cholesky factor comes from ``torch.linalg.cholesky_ex`` with
``check_errors=False``: a covariance that is not positive definite gives
a garbage factor instead of an exception, and no status is copied back
to the host (the reference returns NaNs and never raises either).
"""

from __future__ import annotations

import functools

import torch

from . import se3

TANGENT_DIM = se3.TANGENT_DIM  # 12


@functools.lru_cache(maxsize=64)
def _weights_on(n, alpha, beta, kappa, device):
    lam = alpha * alpha * (n + kappa) - n
    wm0 = lam / (n + lam)
    wc0 = wm0 + (1.0 - alpha * alpha + beta)
    wi = 1.0 / (2.0 * (n + lam))
    w_mean = torch.tensor([wm0] + [wi] * (2 * n), dtype=torch.float32,
                          device=device)
    w_cov = torch.tensor([wc0] + [wi] * (2 * n), dtype=torch.float32,
                         device=device)
    return w_mean, w_cov, lam


def unscented_weights(n: int = TANGENT_DIM, alpha: float = 1.0,
                      beta: float = 2.0, kappa: float = 0.0, device=None):
    """Standard UT weights (Wan–van der Merwe parametrization) →
    (w_mean (2n+1,), w_cov (2n+1,), lambda). The two tensors are built
    once per (n, parameters, device) and shared: do not write to them."""
    return _weights_on(int(n), float(alpha), float(beta), float(kappa),
                       None if device is None else torch.device(device))


def default_ut_params(n: int = TANGENT_DIM):
    """alpha=1, beta=2 (Gaussian-optimal), kappa=1 → lambda=1 > 0."""
    return dict(alpha=1.0, beta=2.0, kappa=1.0)


def _deltas(cov, lam):
    n = cov.shape[-1]
    # Cholesky of (n + lam) * cov; jitter for PSD safety.
    scaled = (n + lam) * cov + 1e-12 * torch.eye(n, dtype=cov.dtype,
                                                 device=cov.device)
    L = torch.linalg.cholesky_ex(scaled, check_errors=False).L
    Lt = L.transpose(-1, -2)
    return torch.cat([cov.new_zeros((1, n)), Lt, -Lt], dim=0)  # (2n+1, n)


def sigma_points(mean_state, cov, alpha=1.0, beta=2.0, kappa=1.0):
    """Generate 2n+1 sigma states around (mean_state (13,), cov (12,12)).

    Returns (states (2n+1, 13), tangents (2n+1, 12), w_mean, w_cov);
    ``tangents`` are the deviations in the tangent space at mean_state.
    """
    n = cov.shape[-1]
    w_mean, w_cov, lam = unscented_weights(n, alpha, beta, kappa, cov.device)
    deltas = _deltas(cov, lam)
    states = se3.state_boxplus(mean_state[None, :], deltas)
    return states, deltas, w_mean, w_cov


def scene_sigma_points(mean_states, cov, alpha=1.0, beta=2.0, kappa=1.0):
    """Sigma points for a K-object scene (joint tangent space).

    Args:
      mean_states: (K, 13); cov: (12K, 12K) joint tangent covariance.
    Returns (states (2n+1, K, 13), deltas (2n+1, 12K), w_mean, w_cov).
    """
    K = mean_states.shape[0]
    n = cov.shape[-1]
    w_mean, w_cov, lam = unscented_weights(n, alpha, beta, kappa, cov.device)
    deltas = _deltas(cov, lam)
    states = se3.state_boxplus(mean_states[None],
                               deltas.reshape(-1, K, TANGENT_DIM))
    return states, deltas, w_mean, w_cov


def scene_reconstruct_moments(states, ref_states, w_mean, w_cov):
    """Joint tangent moments of scene sigma states (K objects).

    Args: states (S, K, 13), ref_states (K, 13).
    Returns (mean_states (K, 13), cov (12K, 12K), centered (S, 12K)).
    """
    S = states.shape[0]
    tangents = se3.state_boxminus(states, ref_states[None]).reshape(S, -1)
    mean_t = w_mean @ tangents
    mean_states = se3.state_boxplus(
        ref_states, mean_t.reshape(-1, TANGENT_DIM))
    centered = tangents - mean_t[None, :]
    cov = (w_cov[:, None] * centered).transpose(-1, -2) @ centered
    return mean_states, cov, centered


def reconstruct_moments(states, ref_state, w_mean, w_cov):
    """Tangent-space mean/cov of sigma states, referenced at ``ref_state``.

    Returns (mean_state (13,), cov (12,12), centered_tangents (2n+1, 12)).
    """
    tangents = se3.state_boxminus(states, ref_state[None, :])  # (S, 12)
    mean_t = w_mean @ tangents
    mean_state = se3.state_boxplus(ref_state, mean_t)
    centered = tangents - mean_t[None, :]
    cov = (w_cov[:, None] * centered).transpose(-1, -2) @ centered
    return mean_state, cov, centered
