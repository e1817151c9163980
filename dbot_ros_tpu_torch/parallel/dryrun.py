"""Dry run of the distributed surface on the ranks of the default group.

Port of ``dryrun_multichip`` (``__graft_entry__.py:97-207``), at its
sizes (8 particles a rank, an 8×8 camera, pixel block 8) and with its
assertions:

1. two objects through the fused sensor, a forced resample, the counts
   exchange (capacity 128);
2. the island step (exact ``"xla"`` sensor);
3. the multi-scene step, 2 scenes × (world / 2) ranks, fused sensor,
   forced resample (when the world is even);
4. the neighbor exchange with skewed weights (only even ranks' particles
   weigh), so surplus really hops between ranks;
5. the ring exchange, forced resample.

Run on every rank: ``dryrun(device)`` after the default group is up.
"""

from __future__ import annotations

import numpy as np
import torch

from dbot_ros_tpu_torch.models import beam, occlusion, transition
from dbot_ros_tpu_torch.models.sensor import make_rb_sensor, render_scene
from dbot_ros_tpu_torch.parallel import comm as comm_mod
from dbot_ros_tpu_torch.parallel import dist_filter
from dbot_ros_tpu_torch.utils.camera import make_camera
from dbot_ros_tpu_torch.utils.mesh import box_mesh


def small_problem(device, hw=8, two_objects=False, backend="xla", nb=16):
    """Camera, meshes, transition, sensor and start pose(s) of the dry run
    (the reference's ``_small_problem``)."""
    K = np.array([[24.0, 0, hw // 2], [0, 24.0, hw // 2], [0, 0, 1.0]])
    cam = make_camera(K, hw, hw, device=device)
    meshes = [box_mesh(0.08, 0.06, 0.05, device=device)]
    if two_objects:
        meshes.append(box_mesh(0.05, 0.05, 0.05, device=device))
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0,
                               device=device)
    op = occlusion.make_occlusion_params(device=device)
    tp = transition.make_transition_params(0.4, 1.5, damping=8.0,
                                           device=device)
    kw = {"nb": nb} if backend == "pallas" else {"tri_chunk": 128}
    sensor = make_rb_sensor(meshes, cam, bp, op, backend=backend,
                            device=device, **kw)
    if two_objects:
        pose0 = torch.tensor([[-0.05, 0.0, 0.6, 1, 0, 0, 0],
                              [0.06, 0.0, 0.62, 1, 0, 0, 0]],
                             device=device)
    else:
        pose0 = torch.tensor([0.0, 0.0, 0.6, 1, 0, 0, 0], device=device)
    return cam, meshes, tp, sensor, pose0


def observation(meshes, pose0, cam):
    poses = pose0 if pose0.ndim == 2 else pose0[None]
    z = render_scene(meshes, poses, cam.rays, 128)
    return torch.where(torch.isfinite(z), z, torch.nan)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _global_abs_log_weights(comm, belief):
    return float(comm.all_reduce(belief.log_weights.abs().sum()))


def dryrun(device, timeout_s: float = comm_mod.DEFAULT_TIMEOUT_S):
    """The five cases on the default group; raises on a failed assertion
    and returns what each case read on this rank."""
    world = comm_mod.Comm()
    n = world.size
    dt = 1.0 / 30.0
    out = {"world": n, "rank": world.rank}

    # 1. fused sensor, K = 2, forced resample, counts exchange
    cam, meshes, tp, sensor, poses0 = small_problem(
        device, two_objects=True, backend="pallas", nb=8)
    belief = dist_filter.init_distributed_belief(
        world, poses0, 8 * n, cam.num_pixels, sensor=sensor, device=device)
    step = dist_filter.make_distributed_step(
        world, sensor, tp, dt, max_kl_divergence=-1.0, exchange="counts",
        capacity=128)
    belief, mean_state, ess = step(belief, observation(meshes, poses0, cam))
    _check(tuple(mean_state.shape) == (2, 13), "mean state shape")
    _check(bool(torch.isfinite(mean_state).all()), "mean state not finite")
    _check(_global_abs_log_weights(world, belief) == 0.0,
           "forced resample did not fire")
    out["fused_counts_ess"] = float(ess)

    # 2. island step, exact sensor
    cam1, meshes1, tp1, sensor1, pose1 = small_problem(device)
    z1 = observation(meshes1, pose1, cam1)
    b1 = dist_filter.init_distributed_belief(world, pose1, 8 * n,
                                             cam1.num_pixels, sensor=sensor1,
                                             device=device)
    isl = dist_filter.make_island_step(world, sensor1, tp1, dt,
                                       max_kl_divergence=0.5,
                                       island_max_kl=0.3)
    b1, ms1, _ = isl(b1, z1)
    _check(bool(torch.isfinite(ms1).all()), "island mean not finite")

    # 3. scenes × particles, fused sensor, forced resample
    if n >= 2 and n % 2 == 0:
        cam2, meshes2, tp2, sensor2, pose2 = small_problem(
            device, backend="pallas", nb=8)
        groups = dist_filter.make_scene_groups(2, n // 2, timeout_s)
        beliefs = dist_filter.init_multi_scene_belief(
            groups, pose2, 2, 4 * n, cam2.num_pixels, sensor=sensor2,
            device=device)
        step2 = dist_filter.make_multi_scene_step(
            groups, sensor2, tp2, dt, max_kl_divergence=-1.0, capacity=128)
        z2 = observation(meshes2, pose2, cam2)
        beliefs, ms2, _ = step2(beliefs, torch.stack([z2] * len(beliefs)))
        _check(tuple(ms2.shape) == (1, 1, 13), "multi-scene mean shape")
        _check(bool(torch.isfinite(ms2).all()), "multi-scene not finite")
        _check(sum(_global_abs_log_weights(groups.particles, b)
                   for b in beliefs) == 0.0,
               "forced multi-scene resample did not fire")
        out["multi_scene"] = True

    # 4. neighbor exchange, skewed weights: only even ranks' particles
    # weigh, so every odd rank imports its parents from a neighbour (span
    # 1: the hop ppermutes, not the fallback)
    b4 = dist_filter.init_distributed_belief(world, pose1, 8 * n,
                                             cam1.num_pixels, sensor=sensor1,
                                             device=device)
    b4.log_weights = torch.full_like(b4.log_weights,
                                     0.0 if world.rank % 2 == 0 else -40.0)
    step4 = dist_filter.make_distributed_step(
        world, sensor1, tp1, dt, max_kl_divergence=-1.0,
        exchange="neighbor", max_hops=1)
    b4, ms4, _ = step4(b4, z1)
    _check(bool(torch.isfinite(ms4).all()), "neighbor mean not finite")
    _check(_global_abs_log_weights(world, b4) == 0.0,
           "forced neighbor resample did not fire")
    _check(bool(torch.isfinite(b4.states).all()), "neighbor states")

    # 5. ring exchange, forced resample
    b3 = dist_filter.init_distributed_belief(world, pose1, 8 * n,
                                             cam1.num_pixels, sensor=sensor1,
                                             device=device)
    step3 = dist_filter.make_distributed_step(
        world, sensor1, tp1, dt, max_kl_divergence=-1.0, exchange="ring")
    b3, ms3, _ = step3(b3, z1)
    _check(bool(torch.isfinite(ms3).all()), "ring mean not finite")
    _check(_global_abs_log_weights(world, b3) == 0.0,
           "forced ring resample did not fire")
    out["cases"] = 5 if "multi_scene" in out else 4
    return out
