"""Frozen copy of ``dbot_ros_tpu_torch/models/transition.py`` (commit 8da1569), with its
imports pointed at the other frozen copies beside it. The benchmark's
reference computes with it; it imports nothing of the port, so later
changes to the port cannot move the yardstick.

The original docstring follows.

Object motion model on SE(3): damped-Wiener pose dynamics.

Port of ``dbot_ros_tpu/models/transition.py``. Per 3-dof group
(translation and so(3) tangent independently):

    v' = a v + xi_v,   a = exp(-damping · dt)
    x' = x + v · dt · abar + xi_x,  abar = (1 - a)/(damping · dt)

with integrated-Wiener noise: Cov[xi_v] = sigma² dt, Cov[xi_x] =
sigma² dt³/3, Corr = √3/2. The noise enters as two standard-normal
drivers ``e1``/``e2`` that callers may pass in (parity tests replay the
JAX package's draws); absent, they are drawn from ``generator``. ``dt``
is a number or a 0-d tensor; the sampler works in float32 on the device,
as the JAX step with ``dt`` traced (no host read, so a CUDA graph can
hold it).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import se3

_RHO = 0.8660254037844386  # sqrt(3)/2


@dataclasses.dataclass(frozen=True)
class TransitionParams:
    linear_acceleration_sigma: torch.Tensor   # [m/s^1.5]
    angular_acceleration_sigma: torch.Tensor  # [rad/s^1.5]
    damping: torch.Tensor                     # [1/s]


def make_transition_params(linear_acceleration_sigma=0.02,
                           angular_acceleration_sigma=0.1,
                           damping=4.0, device=None) -> TransitionParams:
    def f(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return TransitionParams(f(linear_acceleration_sigma),
                            f(angular_acceleration_sigma), f(damping))


def as_dt(dt, device=None) -> torch.Tensor:
    """``dt`` as a 0-d float32 tensor on ``device`` (default: its own): a
    tensor is cast, a number becomes a fill on the device, never a copy
    from the host."""
    if isinstance(dt, torch.Tensor):
        return dt.to(device=device, dtype=torch.float32)
    return torch.full((), float(dt), dtype=torch.float32, device=device)


def _damping_factors(params: TransitionParams, dt):
    gdt = params.damping * dt
    a = torch.exp(-gdt)
    abar = torch.where(gdt > 1e-4, (1.0 - a) / torch.clamp_min(gdt, 1e-12),
                       1.0 - 0.5 * gdt)
    return a, abar


def transition_mean(states, dt, params: TransitionParams):
    """Deterministic part of the dynamics."""
    a, abar = _damping_factors(params, dt)
    pose = se3.state_pose(states)
    vel = se3.state_velocity(states)
    disp = torch.cat([vel[..., :3] * (dt * abar),
                      vel[..., 3:6] * (dt * abar)], dim=-1)
    new_pose = se3.pose_boxplus(pose, disp)
    return se3.make_state(new_pose, a * vel)


def sample_transition(states, dt, params: TransitionParams, e1=None,
                      e2=None, generator=None):
    """Sample the stochastic transition for a batch of states ``[..., 13]``.

    ``e1`` (velocity driver) and ``e2`` (extra position driver) are
    standard normals of shape ``states.shape[:-1] + (6,)``; each one not
    given is drawn from ``generator`` (e1 first). ``dt`` (seconds) is a
    number or a 0-d tensor, taken as float32.
    """
    dt = as_dt(dt, states.device)
    mean = transition_mean(states, dt, params)
    shape = states.shape[:-1] + (6,)
    if e1 is None:
        e1 = torch.randn(shape, generator=generator, dtype=states.dtype,
                         device=states.device)
    if e2 is None:
        e2 = torch.randn(shape, generator=generator, dtype=states.dtype,
                         device=states.device)
    sig = torch.cat([params.linear_acceleration_sigma.expand(3),
                     params.angular_acceleration_sigma.expand(3)])
    sd_v = sig * torch.sqrt(dt)
    sd_x = sig * torch.sqrt(dt ** 3 / 3.0)

    xi_v = sd_v * e1
    xi_x = sd_x * (_RHO * e1 + math.sqrt(1.0 - _RHO * _RHO) * e2)

    pose = se3.pose_boxplus(se3.state_pose(mean), xi_x)
    vel = se3.state_velocity(mean) + xi_v
    return se3.make_state(pose, vel)


def process_noise_cov(dt, params: TransitionParams, dtype=torch.float32):
    """12×12 tangent-space process covariance, order [dx, dθ, dv, dω].

    Block structure per axis i: the exact integrated-Wiener 2×2
    ``sigma² [[dt³/3, dt²/2], [dt²/2, dt]]`` between position and velocity.
    ``dt`` is a Python float or a 0-d tensor.
    """
    sl = params.linear_acceleration_sigma ** 2
    sa = params.angular_acceleration_sigma ** 2
    sig2 = torch.cat([sl.expand(3), sa.expand(3)]).to(dtype)  # per pose-axis
    qxx = torch.diag(sig2 * dt ** 3 / 3.0)
    qxv = torch.diag(sig2 * dt ** 2 / 2.0)
    qvv = torch.diag(sig2 * dt)
    return torch.cat([torch.cat([qxx, qxv], dim=1),
                      torch.cat([qxv, qvv], dim=1)], dim=0)
