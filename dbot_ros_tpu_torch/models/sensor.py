"""Rao-Blackwell depth-image sensor: render → compare → occlusion-filter.

Port of ``dbot_ros_tpu/models/sensor.py``. The contract, as in the
reference plus a ``commit`` flag:

    loglik_fn(states [P,K,13], occ, z_obs [N], dt, commit=True) →
        (loglik [P], occ')

``backend="pallas"`` selects the port's fused sensor (CUDA kernels on a
CUDA device, their plain versions on the CPU), so the JAX package's
configs drive the port unchanged. ``backend="xla"`` is the exact path:
the chunked matmul raycast of every particle (ops/raycast.py) followed by
``image_loglik`` on the ``(P, N)`` occlusion map. ``backend="deferred"``
renders every particle against per-pixel candidate triangles found at
the particles' mean pose (ops/deferred.py), in chunks of particles sized
from the device's memory (ops/budget.py), and scores with the same
``image_loglik``. Multi-object scenes take the per-pixel minimum depth
over the objects.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dbot_ros_tpu_torch.models.beam import BeamParams
from dbot_ros_tpu_torch.models.image_loglik import image_loglik
from dbot_ros_tpu_torch.models.occlusion import OcclusionParams
from dbot_ros_tpu_torch.ops import raycast
from dbot_ros_tpu_torch.ops.budget import (HOST_WORKSPACE_BYTES,
                                            deferred_particle_chunk,
                                            xla_tri_chunk)
from dbot_ros_tpu_torch.utils.camera import CameraModel
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh


def render_scene(meshes: Sequence[TriangleMesh], poses, rays,
                 tri_chunk: int = 512):
    """Min-depth over objects: poses [..., K, 7] → depth [..., N]."""
    depth = None
    for k, mesh in enumerate(meshes):
        d = raycast.raycast_depth(mesh, poses[..., k, :], rays, tri_chunk)
        depth = d if depth is None else torch.minimum(depth, d)
    return depth


def make_rb_sensor(meshes, camera: CameraModel, beam_params: BeamParams,
                   occ_params: OcclusionParams, frame_rate: float = 30.0,
                   backend: str = "xla", tri_chunk: int = 512,
                   device=None, **backend_kwargs):
    """Build the loglik_fn for the particle filter on ``device`` (default:
    the camera's). ``backend_kwargs`` go to the fused sensor's factory;
    the ``"xla"`` backend ignores them, as the reference does. The
    ``"deferred"`` backend takes ``particle_chunk`` (particles rendered
    at once; default: sized from ``capacity_bytes``, itself by default
    the CUDA device's memory and, on a CPU device, the exact raycaster's
    host workspace)."""
    if isinstance(meshes, TriangleMesh):
        meshes = [meshes]
    meshes = list(meshes)
    if backend == "pallas":
        from dbot_ros_tpu_torch.ops.fused_sensor import make_fused_sensor
        return make_fused_sensor(meshes, camera, beam_params, occ_params,
                                 frame_rate, device=device,
                                 **backend_kwargs)
    if backend not in ("xla", "deferred"):
        raise ValueError(f"unknown sensor backend: {backend!r}")

    from dbot_ros_tpu_torch.ops.fused_sensor import _params_to

    dev = torch.device(device if device is not None
                       else camera.rays.device)
    meshes = [m.to(dev) for m in meshes]
    camera = camera.to(dev)
    bp, op = _params_to(beam_params, dev), _params_to(occ_params, dev)

    if backend == "deferred":
        return _make_deferred_sensor(meshes, camera, bp, op, frame_rate,
                                     tri_chunk, dev, **backend_kwargs)

    def loglik_fn(states, occ, z_obs, dt, commit=True):
        # degrade the triangle chunk so the (P, N, chunk) intermediate fits
        chunk = xla_tri_chunk(states.shape[0], camera.num_pixels,
                              tri_chunk)
        depth = render_scene(meshes, states[..., :7], camera.rays, chunk)
        ll, occ_post = image_loglik(depth, z_obs, occ, bp, op,
                                    dt_frames=dt * frame_rate)
        return ll, (occ_post if commit else occ)

    return loglik_fn


def _make_deferred_sensor(meshes, camera, bp, op, frame_rate, tri_chunk,
                          dev, particle_chunk: int = None,
                          capacity_bytes: int = None):
    """The candidate-set sensor: one exact reference render per object at
    the particles' mean pose, then candidate-set intersection for the
    whole batch, ``particle_chunk`` particles at a time; multi-object
    scenes min-combine the per-object depths."""
    from dbot_ros_tpu_torch.ops.deferred import make_deferred_renderer
    from dbot_ros_tpu_torch.utils import se3

    num_candidates = 4          # the reference's (its renderer's default)
    renders = [
        make_deferred_renderer(m, camera.rays, camera.height, camera.width,
                               num_candidates=num_candidates,
                               tri_chunk=tri_chunk)
        for m in meshes]

    def chunk_for(num_particles):
        if particle_chunk is not None:
            return max(int(particle_chunk), 1)
        capacity = capacity_bytes
        if capacity is None and dev.type != "cuda":
            capacity = HOST_WORKSPACE_BYTES
        return deferred_particle_chunk(
            num_particles, camera.num_pixels, num_candidates, device=dev,
            capacity_bytes=capacity)

    def loglik_fn(states, occ, z_obs, dt, commit=True):
        num = states.shape[0]
        chunk = chunk_for(num)
        loglik_fn.last_particle_chunk = chunk
        # per frame and object: the candidate table at the mean pose and
        # the slack of the whole cloud, shared by all chunks
        tables = [(r.candidates(se3.states_mean(states[:, k])[:7]),
                   r.slack(states[..., k, :7]))
                  for k, r in enumerate(renders)]
        parts = []
        for lo in range(0, num, chunk):
            depth = None
            for k, (render, (cand, slack)) in enumerate(
                    zip(renders, tables)):
                d = render(None, states[lo:lo + chunk, k, :7], cand, slack)
                depth = d if depth is None else torch.minimum(depth, d)
            parts.append(depth.contiguous())
        depth = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        ll, occ_post = image_loglik(depth, z_obs, occ, bp, op,
                                    dt_frames=dt * frame_rate)
        return ll, (occ_post if commit else occ)

    loglik_fn.last_particle_chunk = None
    return loglik_fn
