"""Weak-scaling harness of the distributed RBC-PF.

Port of ``dbot_ros_tpu/parallel/scaling.py``: filter steps per second at
growing group sizes with the particle budget grown in proportion (more
ranks, more particles, the same frame rate). Efficiency(n) =
steps/s(n) / steps/s(1). Ranks that share one card (two gloo ranks on
one H100) measure the mechanics only, not scaling efficiency. The step
is timed as users run it: captured under NCCL, eager over gloo
(``capture``, see ``dist_filter.resolve_capture``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch
import torch.distributed as dist

from dbot_ros_tpu_torch.parallel import comm as comm_mod
from dbot_ros_tpu_torch.parallel import dist_filter


@dataclasses.dataclass
class ScalingResult:
    device_counts: List[int]
    steps_per_s: List[float]
    particles: List[int]
    efficiency: List[float]

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def run_scaling(sensor, trans_params, camera, initial_pose,
                particles_per_device: int = 1024, device_counts=None,
                frames: int = 20, dt: float = 1.0 / 30.0, z_obs=None,
                timeout_s: float = comm_mod.DEFAULT_TIMEOUT_S,
                capture=None) -> ScalingResult:
    """Sweep over group sizes that divide the world: for each size ``n``
    the first ``n`` ranks step ``particles_per_device · n`` particles
    ``frames`` times after one warm-up step (the rest wait). Every rank
    of the world calls this and gets the same result (the slowest
    member's time per step)."""
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32)
                         if d <= world and world % d == 0]
    bad = [n for n in device_counts if n < 1 or world % n]
    if bad:
        raise ValueError(f"group sizes {bad} do not divide the world "
                         f"({world} ranks)")
    if z_obs is None:
        raise ValueError("provide a depth observation z_obs")
    world_comm = comm_mod.Comm()
    steps_per_s, particles = [], []
    for n in device_counts:
        group = dist_filter.make_particle_group(n, timeout_s)
        p = particles_per_device * n
        seconds = 0.0
        if group is not None:
            belief = dist_filter.init_distributed_belief(
                group, initial_pose, p, camera.num_pixels, sensor=sensor,
                device=z_obs.device)
            step = dist_filter.make_distributed_step(
                group, sensor, trans_params, dt, max_kl_divergence=0.8,
                capture=capture)
            belief, _, _ = step(belief, z_obs)
            _sync(z_obs)
            t0 = time.perf_counter()
            for _ in range(frames):
                belief, _, _ = step(belief, z_obs)
            _sync(z_obs)
            seconds = (time.perf_counter() - t0) / frames
        slowest = world_comm.all_reduce(
            torch.tensor(seconds, device=z_obs.device), "max")
        steps_per_s.append(1.0 / float(slowest))
        particles.append(p)
    eff = [s / steps_per_s[0] for s in steps_per_s]
    return ScalingResult(list(device_counts), steps_per_s, particles, eff)
