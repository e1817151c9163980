"""numpy → torch conversion of the JAX package's state, and its
checkpoints (:func:`checkpoint_from_jax`). Config dicts need no
conversion: ``dbot_ros_tpu_torch.config`` loads the same keys.

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
from dbot_ros_tpu_torch.filters.rgf import GaussianBelief
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


def distributed_belief_from_jax(states, log_weights, occlusion, rank: int,
                                size: int, num_pixels: int, nb: int = 64,
                                age=None, occ_dtype=torch.float32,
                                device=None) -> ParticleBelief:
    """Rank ``rank``'s block of a belief of the JAX package's distributed
    filter over ``size`` shards (its leaves as numpy arrays).

    ``states`` (P, K, 13) and ``log_weights`` (P,) are the global leaves;
    the rank takes rows ``[rank·L, (rank+1)·L)`` with ``L = P / size``.
    The occlusion leaf is either the (P, N) map (rows split the same way)
    or the fused sensor's kernel layout, which the JAX package keeps as
    the concatenation of the ``size`` local kernel-layout blocks along
    axis 0 (dist_filter.py:146-147); the lazy ``age`` leaf is
    concatenated alike. The rank's block goes through
    :func:`occlusion_from_jax`.
    """
    states = np.asarray(states)
    P = states.shape[0]
    if P % size:
        raise ValueError(f"{P} particles do not split over {size} ranks")
    L = P // size
    rows = slice(rank * L, (rank + 1) * L)
    occ = np.asarray(occlusion)
    if occ.shape == (P, num_pixels):
        block = occ[rows]
    else:
        if occ.shape[0] % size:
            raise ValueError(f"occlusion leaf {occ.shape} does not split "
                             f"over {size} ranks")
        n = occ.shape[0] // size
        block = occ[rank * n:(rank + 1) * n]
    if age is not None:
        age = np.asarray(age)
        na = age.shape[0] // size
        age = age[rank * na:(rank + 1) * na]
    return ParticleBelief(
        states=_tensor(states[rows], device),
        log_weights=_tensor(np.asarray(log_weights)[rows], device),
        occlusion=occlusion_from_jax(block, L, num_pixels, nb, age,
                                     occ_dtype, device))


def gaussian_belief_from_numpy(mean, cov, background, occ_prior=None,
                               device=None) -> GaussianBelief:
    """A GaussianBelief from the JAX belief's leaves (its key, kept there
    for symmetry only, is dropped: the filter is deterministic)."""
    return GaussianBelief(
        mean=_tensor(mean, device), cov=_tensor(cov, device),
        background=_tensor(background, device),
        occ_prior=None if occ_prior is None else _tensor(occ_prior, device))


def _npz_leaf(data, name):
    """One array of a JAX-written checkpoint: bfloat16 was stored as a
    uint16 view under ``name__bf16`` and comes back as float32 (exact)."""
    if name + "__bf16" in data:
        bits = np.asarray(data[name + "__bf16"]).astype(np.uint32) << 16
        return bits.view(np.float32), True
    if name in data:
        return np.asarray(data[name]), False
    return None, False


def checkpoint_from_jax(path, num_pixels: int = None, nb: int = 64,
                        occ_dtype=None, device=None):
    """Read a checkpoint written by the JAX package's
    ``runtime.checkpoint.save_belief`` into the port's belief.

    A Gaussian checkpoint gives a GaussianBelief (``occ_prior`` may be
    absent; the file's ``key`` is ignored) and needs none of the other
    arguments. A particle checkpoint needs ``num_pixels``: its occlusion
    field is a (P, N) map, the fused sensor's kernel layout
    ``(n_pad·pr, 128)``, or the lazy ``(q, age)`` pair of leaves; it goes
    through :func:`occlusion_from_jax`. ``nb`` must be the JAX sensor's
    pixel block. ``occ_dtype`` defaults to the stored one (bfloat16 where
    the file tags it, else float32). The JAX belief's PRNG key is
    dropped: seed a ``torch.Generator`` instead.
    """
    data = np.load(path, allow_pickle=False)
    kind = str(data["__kind__"])
    if kind == "gaussian":
        return gaussian_belief_from_numpy(
            data["mean"], data["cov"], data["background"],
            data["occ_prior"] if "occ_prior" in data else None, device)
    if kind != "particle":
        raise ValueError(f"unknown belief kind {kind!r}")
    if num_pixels is None:
        raise ValueError("a particle checkpoint needs num_pixels")
    occ, is_bf16 = _npz_leaf(data, "occlusion")
    age = None
    if occ is None:
        occ, is_bf16 = _npz_leaf(data, "occlusion__0")
        age, _ = _npz_leaf(data, "occlusion__1")
        if occ is None:
            raise KeyError("checkpoint has no occlusion field")
    if occ_dtype is None:
        occ_dtype = torch.bfloat16 if is_bf16 else torch.float32
    return belief_from_numpy(data["states"], data["log_weights"], occ,
                             num_pixels, age=age, nb=nb,
                             occ_dtype=occ_dtype, device=device)


# a JAX FusedSensor's settings that the port's constructor takes as they
# are (the map's dtype comes separately, by name)
FUSED_SENSOR_SETTINGS = ("frame_rate", "levels", "num_candidates", "radius",
                          "nb", "bary_slack", "bary_slack_px",
                          "reference_poses", "merge", "lineage_gather")


def fused_sensor_kwargs_from_jax(attrs):
    """The port's ``FusedSensor`` keyword arguments from a plain dict of a
    JAX ``FusedSensor``'s settings: its attributes named in
    ``FUSED_SENSOR_SETTINGS`` (``frame_rate`` optional, ``levels`` a
    list of pairs, ``bary_slack`` None for the automatic rule) and
    ``occ_dtype``, the map dtype's name (``"bfloat16"`` or
    ``"float32"``). Pass ``levels`` explicitly: it is what the JAX
    constructor made of ``active_cap_frac``/``tri_cap_frac``. Unknown
    keys raise, so that a setting cannot be dropped on the way.
    """
    attrs = dict(attrs)
    unknown = set(attrs) - set(FUSED_SENSOR_SETTINGS) - {"occ_dtype"}
    if unknown:
        raise ValueError(f"unknown fused-sensor settings: {sorted(unknown)}")
    out = {k: attrs[k] for k in FUSED_SENSOR_SETTINGS if k in attrs}
    if "levels" in out:
        out["levels"] = [(float(a), float(t)) for a, t in out["levels"]]
    if "occ_dtype" in attrs:
        name = str(attrs["occ_dtype"])
        if name not in ("bfloat16", "float32"):
            raise ValueError(f"occlusion dtype {name!r}: the port stores "
                             "bfloat16 or float32")
        out["occ_dtype"] = getattr(torch, name)
    return out
