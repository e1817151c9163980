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

    def clone(self) -> "ParticleBelief":
        """A copy that owns its tensors: a tracker's step overwrites the
        belief before it (utils/graphs.py), so a belief kept across a
        ``track`` call is a copy."""
        occ = self.occlusion
        occ = (type(occ)(x.clone() for x in occ)
               if isinstance(occ, (tuple, list)) else occ.clone())
        return ParticleBelief(self.states.clone(), self.log_weights.clone(),
                              occ)

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


NEVER_RESAMPLE_KL = 1e8


def _maybe_resample(log_w, states, occ, old_loglik, max_kl, occ_gather,
                    u=None, generator=None):
    """KL-triggered systematic resampling of (states, occ, old_loglik).

    No host branch on the device's KL value: the parent vector is
    ``where``-selected between the systematic parents and the identity,
    and the gathers run every frame (``max_kl >= 1e8`` skips all of it).
    Indices are clamped into range (the reference's ``mode="clip"``).
    """
    kl = rs.kl_to_uniform(log_w)
    if max_kl >= NEVER_RESAMPLE_KL:
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


def draw_noise(noise: Sequence[BlockNoise], generator=None):
    """Fill ``noise`` (one :class:`BlockNoise` of buffers per block) in
    place from ``generator``, in the order :func:`rbcpf_step` draws: per
    block ``e1``, ``e2``, then ``u`` (a block whose ``u`` is None draws
    none, as a step whose ``max_kl_divergence`` never resamples). A step
    that replays the filled buffers equals one that draws from the same
    generator, and the generator ends where that step leaves it."""
    for nb in noise:
        nb.e1.normal_(generator=generator)
        nb.e2.normal_(generator=generator)
        if nb.u is not None:
            nb.u.uniform_(generator=generator)
    return noise


def propose_block(states, b: int, dt, trans_params: TransitionParams,
                  noise: Optional[BlockNoise] = None, generator=None):
    """Block ``b``'s proposal: its poses drawn from the transition over
    ``dt`` (``noise.e1``/``e2``, each drawn from ``generator`` when
    None), the other blocks as they were; a new (P, K, 13) tensor."""
    noise = noise if noise is not None else BlockNoise()
    new_block = sample_transition(states[:, b], dt, trans_params,
                                  e1=noise.e1, e2=noise.e2,
                                  generator=generator)
    states = states.clone()
    states[:, b] = new_block
    return states


def weigh_block(belief: ParticleBelief, loglik, occ_post, old_loglik,
                resampled, commit: bool, max_kl_divergence, occ_gather,
                u=None, generator=None):
    """The rest of a block after its sensor call: the telescoping weight
    update and KL-triggered resampling of ``belief`` (its states the
    block's proposal). The occlusion is the sensor's ``occ_post`` when
    ``commit``, else the belief's. Returns (belief, old_loglik for the
    next block, resampled so far, KL before resampling)."""
    occ = occ_post if commit else belief.occlusion
    log_w = belief.log_weights + loglik - old_loglik
    (states, occ, old_loglik), log_w, did, kl = _maybe_resample(
        log_w, belief.states, occ, loglik, max_kl_divergence, occ_gather,
        u=u, generator=generator)
    return (ParticleBelief(states=states, log_weights=log_w, occlusion=occ),
            old_loglik, resampled | did, kl)


def summarize(belief: ParticleBelief, loglik, resampled, kl) -> StepInfo:
    """A step's :class:`StepInfo` from its final belief, the last block's
    loglik, whether any block resampled and the last KL."""
    ln, _ = rs.normalize_log_weights(belief.log_weights)
    weights = torch.exp(ln)
    return StepInfo(mean_state=se3.states_mean(belief.states, weights),
                    ess=rs.effective_sample_size(belief.log_weights),
                    kl=kl, resampled=resampled,
                    mean_loglik=torch.sum(weights * loglik))


def program_block(prog, sensor, b: int, belief: ParticleBelief, z_obs, dt,
                  trans_params: TransitionParams, noise: BlockNoise, rest):
    """Coordinate block ``b`` through the step program ``prog``
    (utils/graphs.py): :func:`propose_block` into the states buffer of
    ``belief`` (the program's) and, with a sensor split at its host read
    (``plan_device``), a ``("propose", b)`` graph that ends with the
    sensor's device work before the read, the read
    (``choose_level``), and ``rest(states, plan)`` as the level's
    ``("level", b, level)`` graph; with another sensor one ``("block",
    b)`` graph (``plan`` None). Returns what ``rest`` returned."""
    split = hasattr(sensor, "plan_device")

    def propose():
        states = prog.keep("belief.states", propose_block(
            belief.states, b, dt, trans_params, noise))
        plan = (prog.keep("plan", sensor.plan_device(states, z_obs, dt))
                if split else None)
        return states, plan

    if not split:
        return prog.run(("block", b), lambda: rest(*propose()))
    states, plan = prog.run(("propose", b), propose)
    plan = sensor.choose_level(plan)
    return prog.run(("level", b, plan.level), lambda: rest(states, plan))


def sense(sensor, plan, states, occ, z_obs, dt, commit: bool):
    """A block's sensor call in :func:`program_block`'s ``rest``:
    ``apply`` of the plan where the sensor is split, else the call."""
    if plan is None:
        return sensor(states, occ, z_obs, dt, commit=commit)
    return sensor.apply(plan, states, occ, z_obs, commit=commit)


def occlusion_gather(loglik_fn):
    """The sensor's lineage gather of its occlusion leaf (its
    ``gather_occlusion`` hook), else a row gather of a (P, N) map."""
    return getattr(loglik_fn, "gather_occlusion", None) or _default_gather


def rbcpf_step(belief: ParticleBelief, z_obs, loglik_fn: Callable,
               trans_params: TransitionParams, dt, max_kl_divergence=1.0,
               generator=None,
               noise: Optional[Sequence[BlockNoise]] = None):
    """One filter step (one depth frame) → (new belief, StepInfo).

    Blocks run in object order (:func:`propose_block`, the sensor call,
    :func:`weigh_block`); resampling may trigger after every block. Only
    the last block's sensor call commits the occlusion posterior
    (``commit=False`` before it). Random numbers per block, in the
    reference's order: transition e1, e2, then the resampling u — taken
    from ``noise[b]`` where given, else drawn from ``generator``. ``dt``
    is a number or a 0-d tensor (the trackers pass a device buffer).
    """
    num_objects = belief.num_objects
    occ_gather = occlusion_gather(loglik_fn)
    old_loglik = torch.zeros_like(belief.log_weights)
    resampled = torch.zeros((), dtype=torch.bool,
                            device=belief.log_weights.device)
    for b in range(num_objects):
        nb = noise[b] if noise is not None else BlockNoise()
        states = propose_block(belief.states, b, dt, trans_params, nb,
                               generator)
        commit = b == num_objects - 1
        loglik, occ_post = loglik_fn(states, belief.occlusion, z_obs, dt,
                                     commit=commit)
        belief, old_loglik, resampled, kl = weigh_block(
            dataclasses.replace(belief, states=states), loglik, occ_post,
            old_loglik, resampled, commit, max_kl_divergence, occ_gather,
            u=nb.u, generator=generator)
    return belief, summarize(belief, loglik, resampled, kl)
