"""Rao-Blackwellized coordinate particle filter (RBC-PF) step.

Port of ``dbot_ros_tpu/filters/rbcpf.py`` (Wüthrich et al. IROS 2013):
per sampling block (one per tracked object) sample the block's pose from
the transition, evaluate the log-likelihoods, update the weights with the
telescoping delta, and resample when KL(w ‖ uniform) exceeds
``max_kl_divergence``. The occlusion chain is filtered inside the sensor;
its state follows particle lineages through resampling.

The belief carries no random state: ``rbcpf_step`` draws from the
``generator`` it is given, or replays a per-block noise bundle
(:class:`BlockNoise`), which is how the tests hold it against the JAX
step's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from dbot_ros_tpu_torch.models.transition import (TransitionParams,
                                                  sample_transition)
from dbot_ros_tpu_torch.ops import resample as rs
from dbot_ros_tpu_torch.utils import se3


@dataclasses.dataclass
class ParticleBelief:
    """Weighted particles + the sensor's occlusion state."""

    states: torch.Tensor       # (P, K, 13) poses + velocities, K objects
    log_weights: torch.Tensor  # (P,) unnormalized log weights
    occlusion: object          # sensor-defined leaf ((P, N) map by default)

    @property
    def num_particles(self) -> int:
        return self.states.shape[0]

    @property
    def num_objects(self) -> int:
        return self.states.shape[1]


@dataclasses.dataclass
class StepInfo:
    """Per-frame diagnostics (0-d tensors; field names as the reference's,
    which ``runtime.metrics.FrameMetrics.from_info`` reads)."""

    mean_state: torch.Tensor    # (K, 13)
    ess: torch.Tensor           # after the last block
    kl: torch.Tensor            # KL(w ‖ uniform) before resampling
    resampled: torch.Tensor     # bool: any block triggered resampling
    mean_loglik: torch.Tensor


@dataclasses.dataclass
class BlockNoise:
    """The random numbers of one coordinate block: the transition drivers
    ``e1``/``e2`` (P, 6) and the systematic-resampling uniform ``u``.
    A field left None is drawn from the step's generator."""

    e1: Optional[torch.Tensor] = None
    e2: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None


def init_belief(initial_poses, num_particles: int, num_pixels: int,
                initial_occlusion_prob=0.1, sensor=None,
                hypothesis_logits=None, generator=None, u=None,
                device=None) -> ParticleBelief:
    """All particles at the given pose(s), zero velocity, uniform weights.

    Multi-hypothesis init: ``initial_poses`` (H, K, 7) or (H, 7) with
    ``hypothesis_logits`` (H,) allocates particles across hypotheses by
    systematic resampling of the logits (uniform ``u`` given, or drawn
    from ``generator``). The occlusion leaf comes from
    ``sensor.init_occlusion`` when the sensor has one, else it is the
    (P, N) map.
    """
    initial_poses = torch.as_tensor(initial_poses, dtype=torch.float32,
                                    device=device)
    dev = initial_poses.device
    if hypothesis_logits is not None:
        if initial_poses.ndim == 2:          # (H, 7) single object
            initial_poses = initial_poses[:, None]
        logits = torch.as_tensor(hypothesis_logits, dtype=torch.float32,
                                 device=dev)
        assign = rs.systematic_indices(logits, num_particles, u=u,
                                       generator=generator)
        k = initial_poses.shape[1]
        states = torch.zeros((num_particles, k, 13), device=dev)
        states[..., :7] = initial_poses[assign]
    else:
        if initial_poses.ndim == 1:
            initial_poses = initial_poses[None]
        k = initial_poses.shape[0]
        states = torch.zeros((num_particles, k, 13), device=dev)
        states[..., :7] = initial_poses[None]
    if sensor is not None and hasattr(sensor, "init_occlusion"):
        occ = sensor.init_occlusion(num_particles, initial_occlusion_prob)
    else:
        occ = torch.full((num_particles, num_pixels),
                         float(initial_occlusion_prob), device=dev)
    return ParticleBelief(states=states,
                          log_weights=torch.zeros((num_particles,),
                                                  device=dev),
                          occlusion=occ)


_NEVER_RESAMPLE_KL = 1e8


def _maybe_resample(log_w, states, occ, old_loglik, max_kl, occ_gather,
                    u=None, generator=None):
    """KL-triggered systematic resampling of (states, occ, old_loglik).

    No host branch on the device's KL value: the parent vector is
    ``where``-selected between the systematic parents and the identity,
    and the gathers run every frame (``max_kl >= 1e8`` skips all of it).
    Indices are clamped into range (the reference's ``mode="clip"``).
    """
    kl = rs.kl_to_uniform(log_w)
    if max_kl >= _NEVER_RESAMPLE_KL:
        return ((states, occ, old_loglik), log_w,
                torch.zeros((), dtype=torch.bool, device=log_w.device), kl)
    p = log_w.shape[-1]
    do = kl > max_kl
    idx = torch.where(do, rs.systematic_indices(log_w, p, u=u,
                                                generator=generator),
                      torch.arange(p, device=log_w.device))
    idx = idx.clamp(0, p - 1)
    tree = (states.index_select(0, idx), occ_gather(occ, idx),
            old_loglik.index_select(0, idx))
    log_w2 = torch.where(do, torch.zeros_like(log_w), log_w)
    return tree, log_w2, do, kl


def _default_gather(occ, idx):
    return occ.index_select(0, idx)


def rbcpf_step(belief: ParticleBelief, z_obs, loglik_fn: Callable,
               trans_params: TransitionParams, dt, max_kl_divergence=1.0,
               generator=None,
               noise: Optional[Sequence[BlockNoise]] = None):
    """One filter step (one depth frame) → (new belief, StepInfo).

    Blocks run in object order; resampling may trigger after every block.
    Only the last block's sensor call commits the occlusion posterior
    (``commit=False`` before it). Random numbers per block, in the
    reference's order: transition e1, e2, then the resampling u — taken
    from ``noise[b]`` where given, else drawn from ``generator``.
    """
    num_objects = belief.num_objects
    occ_gather = getattr(loglik_fn, "gather_occlusion", None) or \
        _default_gather

    states = belief.states
    occ = belief.occlusion
    log_w = belief.log_weights
    old_loglik = torch.zeros_like(log_w)
    resampled_any = torch.zeros((), dtype=torch.bool, device=log_w.device)
    kl_last = torch.zeros((), device=log_w.device)
    loglik = old_loglik

    for b in range(num_objects):
        nb = noise[b] if noise is not None else BlockNoise()
        new_block = sample_transition(states[:, b], dt, trans_params,
                                      e1=nb.e1, e2=nb.e2,
                                      generator=generator)
        states = states.clone()
        states[:, b] = new_block

        update = b == num_objects - 1
        loglik, occ_post = loglik_fn(states, occ, z_obs, dt, commit=update)
        if update:
            occ = occ_post

        log_w = log_w + loglik - old_loglik
        old_loglik = loglik

        (states, occ, old_loglik), log_w, did, kl_last = _maybe_resample(
            log_w, states, occ, old_loglik, max_kl_divergence, occ_gather,
            u=nb.u, generator=generator)
        resampled_any = resampled_any | did

    ln, _ = rs.normalize_log_weights(log_w)
    weights = torch.exp(ln)
    mean_state = se3.states_mean(states, weights)      # (K, 13)

    new_belief = ParticleBelief(states=states, log_weights=log_w,
                                occlusion=occ)
    info = StepInfo(mean_state=mean_state,
                    ess=rs.effective_sample_size(log_w),
                    kl=kl_last,
                    resampled=resampled_any,
                    mean_loglik=torch.sum(weights * loglik))
    return new_belief, info
