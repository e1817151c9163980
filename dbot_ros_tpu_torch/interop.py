"""numpy → torch conversion of the JAX package's state.

Takes numpy arrays only (call ``np.asarray`` on JAX leaves first), so the
port still never imports jax. Field names match the JAX dataclasses:
``{f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}``
is a valid ``arrays`` argument. Float arrays become float32 (``make_mesh``
builds in float64), integer arrays int64, ``num_*``/``height``/``width``
Python ints.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dbot_ros_tpu_torch.filters.rbcpf import ParticleBelief
from dbot_ros_tpu_torch.models.beam import BeamParams
from dbot_ros_tpu_torch.models.occlusion import OcclusionParams
from dbot_ros_tpu_torch.models.transition import TransitionParams
from dbot_ros_tpu_torch.ops.fused_sensor import _round_up, particle_pad
from dbot_ros_tpu_torch.utils.camera import CameraModel
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh

_INT_FIELDS = ("num_triangles", "num_vertices", "height", "width")


def _tensor(x, device):
    a = np.asarray(x)
    if a.dtype.kind in "iub":
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


def _from_numpy(cls, arrays, device):
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = arrays[f.name]
        kwargs[f.name] = (int(np.asarray(v)) if f.name in _INT_FIELDS
                          else _tensor(v, device))
    return cls(**kwargs)


def mesh_from_numpy(arrays, device=None) -> TriangleMesh:
    return _from_numpy(TriangleMesh, arrays, device)


def camera_from_numpy(arrays, device=None) -> CameraModel:
    return _from_numpy(CameraModel, arrays, device)


def beam_params_from_numpy(arrays, device=None) -> BeamParams:
    return _from_numpy(BeamParams, arrays, device)


def occlusion_params_from_numpy(arrays, device=None) -> OcclusionParams:
    return _from_numpy(OcclusionParams, arrays, device)


def transition_params_from_numpy(arrays, device=None) -> TransitionParams:
    return _from_numpy(TransitionParams, arrays, device)


def jax_particle_pads(num_particles: int):
    """(p_pad, pr) of the JAX kernel layout (``_particle_pads``): 128
    lanes × pr row-groups, pr rounded up to a multiple of 8."""
    pr = _round_up(max(_round_up(num_particles, 128) // 128, 1), 8)
    return pr * 128, pr


def occlusion_from_jax(occ, num_particles: int, num_pixels: int,
                       nb: int = 64, age=None, occ_dtype=torch.float32,
                       device=None):
    """The port's occlusion leaf from the JAX package's.

    ``occ`` is either a (P, N) particle-major map or the JAX fused
    sensor's kernel layout (n_pad·pr, 128); ``age`` the lazy (n_pad,)
    staleness (then the result is the ``(q, age)`` tuple). The map comes
    out as (n_pad, p_pad) with ``n_pad = round_up(N, nb)``; padding
    particles are taken from the JAX layout where present, else zero.
    """
    P, N = num_particles, num_pixels
    a = np.asarray(occ).astype(np.float32)
    n_pad, p_pad = _round_up(N, nb), particle_pad(P)
    q = np.zeros((n_pad, p_pad), np.float32)
    if a.shape == (P, N):
        q[:N, :P] = a.T
    else:
        jp_pad, pr = jax_particle_pads(P)
        if a.shape != (n_pad * pr, 128):
            raise ValueError(
                f"occlusion must be (P, N) = {(P, N)} or the JAX kernel "
                f"layout {(n_pad * pr, 128)}, got {a.shape}")
        view = a.reshape(n_pad, jp_pad)
        w = min(jp_pad, p_pad)
        q[:, :w] = view[:, :w]
    qt = torch.as_tensor(q, device=device).to(occ_dtype)
    if age is None:
        return qt
    return (qt, torch.tensor(np.asarray(age, np.float32), device=device))


def belief_from_numpy(states, log_weights, occlusion, num_pixels: int,
                      age=None, nb: int = 64, occ_dtype=torch.float32,
                      device=None) -> ParticleBelief:
    """A ParticleBelief from the JAX belief's leaves (the key is dropped:
    the port draws from a torch.Generator)."""
    states = _tensor(states, device)
    return ParticleBelief(
        states=states,
        log_weights=_tensor(log_weights, device),
        occlusion=occlusion_from_jax(occlusion, states.shape[0],
                                     num_pixels, nb, age, occ_dtype,
                                     device))
