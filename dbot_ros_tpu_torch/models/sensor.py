"""Rao-Blackwell depth-image sensor: render → compare → occlusion-filter.

Port of ``dbot_ros_tpu/models/sensor.py``. The contract, as in the
reference plus a ``commit`` flag:

    loglik_fn(states [P,K,13], occ, z_obs [N], dt, commit=True) →
        (loglik [P], occ')

``backend="pallas"`` selects the port's fused sensor (CUDA kernels on a
CUDA device, their plain versions on the CPU), so the JAX package's
configs drive the port unchanged. ``backend="xla"`` is the exact path:
the chunked matmul raycast of every particle (ops/raycast.py) followed by
``image_loglik`` on the ``(P, N)`` occlusion map. Multi-object scenes
take the per-pixel minimum depth over the objects.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dbot_ros_tpu_torch.models.beam import BeamParams
from dbot_ros_tpu_torch.models.image_loglik import image_loglik
from dbot_ros_tpu_torch.models.occlusion import OcclusionParams
from dbot_ros_tpu_torch.ops import raycast
from dbot_ros_tpu_torch.ops.budget import xla_tri_chunk
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
    the ``"xla"`` backend ignores them, as the reference does."""
    if isinstance(meshes, TriangleMesh):
        meshes = [meshes]
    meshes = list(meshes)
    if backend == "pallas":
        from dbot_ros_tpu_torch.ops.fused_sensor import make_fused_sensor
        return make_fused_sensor(meshes, camera, beam_params, occ_params,
                                 frame_rate, device=device,
                                 **backend_kwargs)
    if backend == "deferred":
        raise NotImplementedError(
            "sensor backend 'deferred' is not ported yet (ROADMAP queue A "
            "item 10, the sigma renderer of ops/deferred.py); use "
            "backend='pallas' or 'xla'")
    if backend != "xla":
        raise ValueError(f"unknown sensor backend: {backend!r}")

    from dbot_ros_tpu_torch.ops.fused_sensor import _params_to

    dev = torch.device(device if device is not None
                       else camera.rays.device)
    meshes = [m.to(dev) for m in meshes]
    camera = camera.to(dev)
    bp, op = _params_to(beam_params, dev), _params_to(occ_params, dev)

    def loglik_fn(states, occ, z_obs, dt, commit=True):
        # degrade the triangle chunk so the (P, N, chunk) intermediate fits
        chunk = xla_tri_chunk(states.shape[0], camera.num_pixels,
                              tri_chunk)
        depth = render_scene(meshes, states[..., :7], camera.rays, chunk)
        ll, occ_post = image_loglik(depth, z_obs, occ, bp, op,
                                    dt_frames=dt * frame_rate)
        return ll, (occ_post if commit else occ)

    return loglik_fn
