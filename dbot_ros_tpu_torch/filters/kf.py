"""Linear Kalman filter (vector-space states).

Port of ``dbot_ros_tpu/filters/kf.py``: the exact Gaussian filter for
linear transition ``x' = A x + B u + w, w~N(0,Q)`` and linear sensor
``y = H x + v, v~N(0,R)``. Used for auxiliary estimation and as the
oracle in sigma-point agreement tests.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LinearBelief:
    mean: torch.Tensor  # (n,)
    cov: torch.Tensor   # (n, n)


def predict(belief: LinearBelief, A, Q, B=None, u=None) -> LinearBelief:
    mean = A @ belief.mean
    if B is not None and u is not None:
        mean = mean + B @ u
    cov = A @ belief.cov @ A.T + Q
    return LinearBelief(mean=mean, cov=0.5 * (cov + cov.T))


def update(belief: LinearBelief, y, H, R) -> LinearBelief:
    S = H @ belief.cov @ H.T + R
    # P Hᵀ S⁻¹; no status comes back to the host (a singular S gives
    # garbage, not an exception)
    K = torch.linalg.solve_ex(S.T, H @ belief.cov.T,
                              check_errors=False).result.T
    mean = belief.mean + K @ (y - H @ belief.mean)
    n = belief.mean.shape[-1]
    I_KH = torch.eye(n, dtype=belief.cov.dtype,
                     device=belief.cov.device) - K @ H
    # Joseph form for numerical symmetry/PSD.
    cov = I_KH @ belief.cov @ I_KH.T + K @ R @ K.T
    return LinearBelief(mean=mean, cov=0.5 * (cov + cov.T))


def step(belief: LinearBelief, y, A, Q, H, R, B=None, u=None):
    return update(predict(belief, A, Q, B, u), y, H, R)
