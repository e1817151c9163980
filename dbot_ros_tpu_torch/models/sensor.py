"""Rao-Blackwell depth-image sensor factory.

Port of ``make_rb_sensor`` from ``dbot_ros_tpu/models/sensor.py``. The
contract, as in the reference plus a ``commit`` flag:

    loglik_fn(states [P,K,13], occ, z_obs [N], dt, commit=True) →
        (loglik [P], occ')

``backend="pallas"`` selects the port's fused sensor (CUDA kernels on a
CUDA device, their plain versions on the CPU), so the JAX package's
configs drive the port unchanged.
"""

from __future__ import annotations

from dbot_ros_tpu_torch.models.beam import BeamParams
from dbot_ros_tpu_torch.models.occlusion import OcclusionParams
from dbot_ros_tpu_torch.utils.camera import CameraModel
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh


def make_rb_sensor(meshes, camera: CameraModel, beam_params: BeamParams,
                   occ_params: OcclusionParams, frame_rate: float = 30.0,
                   backend: str = "xla", device=None, **backend_kwargs):
    """Build the loglik_fn for the particle filter on ``device`` (default:
    the camera's). ``backend_kwargs`` go to the backend factory."""
    if isinstance(meshes, TriangleMesh):
        meshes = [meshes]
    if backend == "pallas":
        from dbot_ros_tpu_torch.ops.fused_sensor import make_fused_sensor
        return make_fused_sensor(list(meshes), camera, beam_params,
                                 occ_params, frame_rate, device=device,
                                 **backend_kwargs)
    if backend in ("xla", "deferred"):
        raise NotImplementedError(
            f"sensor backend {backend!r} is not ported yet (ROADMAP queue "
            "A, 'The sensors left out of the first slice'); use "
            "backend='pallas'")
    raise ValueError(f"unknown sensor backend: {backend!r}")
