"""Flat configuration dataclasses with the reference's parameter names.

The port's own copy of ``dbot_ros_tpu/config.py`` (the port imports
nothing of the JAX package): one dataclass per tracker, loadable from
YAML/JSON dicts, consumed once at build time. Parameter names and
defaults follow the reference YAML (``object/…``, ``downsampling_factor``,
``evaluation_count``, ``max_kl_divergence``, noise sigmas, occlusion
probabilities, ``tail_weight``, ``moving_average_update_rate``), so a
config written for the JAX package loads here unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence


@dataclasses.dataclass
class ObjectConfig:
    """Which meshes to track (ref: ObjectResourceIdentifier, D2)."""

    meshes: List[str] = dataclasses.field(default_factory=list)  # .obj paths
    directory: str = ""          # optional base directory (ref: package/dir)
    package: str = ""            # kept for config compatibility; unused
    scale: float = 1.0
    center_object: bool = True   # rotate about centroid (ref D4)

    def mesh_paths(self) -> List[str]:
        import os
        base = self.directory or ""
        return [os.path.join(base, m) if base else m for m in self.meshes]


@dataclasses.dataclass
class CameraConfig:
    """Camera intrinsics + downsampling (ref: CameraData / providers, D6)."""

    # row-major 3x3; None → the default Kinect intrinsics
    camera_matrix: Optional[Sequence[float]] = None
    resolution: Sequence[int] = (480, 640)           # (H, W) native
    downsampling_factor: int = 8
    frame_rate: float = 30.0


@dataclasses.dataclass
class ObservationConfig:
    """Beam + occlusion model parameters (ref D9/D10 + fl BodyTail)."""

    tail_weight: float = 0.02
    model_sigma: float = 0.003
    sigma_factor: float = 0.0014
    min_depth: float = 0.4
    max_depth: float = 5.0
    exponential_rate: float = 1.5
    p_occluded_visible: float = 0.1
    p_occluded_occluded: float = 0.7
    initial_occlusion_prob: float = 0.1


@dataclasses.dataclass
class TransitionConfig:
    """Process model parameters (ref D7/D8)."""

    linear_acceleration_sigma: float = 0.02
    angular_acceleration_sigma: float = 0.1
    damping: float = 4.0  # a.k.a. velocity damping / (1 - velocity_factor)


@dataclasses.dataclass
class ParticleTrackerConfig:
    """Full particle-tracker assembly config."""

    object: ObjectConfig = dataclasses.field(default_factory=ObjectConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    observation: ObservationConfig = dataclasses.field(
        default_factory=ObservationConfig)
    transition: TransitionConfig = dataclasses.field(
        default_factory=TransitionConfig)
    evaluation_count: int = 200        # particle count (ref name)
    max_kl_divergence: float = 1.0
    moving_average_update_rate: float = 1.0  # 1.0 = no smoothing
    backend: str = "xla"               # ref `use_gpu` CPU/GPU switch
    # extra kwargs for the sensor backend factory (e.g. the fused
    # sensor's num_candidates/radius/nb/levels)
    backend_options: dict = dataclasses.field(default_factory=dict)
    seed: int = 0


@dataclasses.dataclass
class GaussianTrackerConfig:
    """Gaussian-tracker assembly config."""

    object: ObjectConfig = dataclasses.field(default_factory=ObjectConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    observation: ObservationConfig = dataclasses.field(
        default_factory=ObservationConfig)
    transition: TransitionConfig = dataclasses.field(
        default_factory=TransitionConfig)
    update_iterations: int = 3
    # temporal occlusion memory: per-pixel occluder-prior chain
    occlusion_memory: bool = True
    # evaluate the update on every s-th pixel (1 = all, <= 0 = auto via
    # ops/budget.rgf_pixel_stride)
    pixel_stride: int = 1
    # sigma-point render backend: "deferred" (candidate pass) or "exact"
    sigma_backend: str = "deferred"
    sigma_radius: int = 3        # candidate dilation radius (pixels)
    sigma_candidates: int = 6    # candidate triangle ids per pixel
    trust_sigma: float = 1.0
    lin_floor_pos: float = 0.008
    lin_floor_rot: float = 0.04
    # upper twin of the linearization floor
    lin_cap_pos: float = 0.04
    lin_cap_rot: float = 0.25
    bg_sigma: float = 0.02
    init_pos_sigma: float = 0.02
    init_rot_sigma: float = 0.1
    init_vel_sigma: float = 0.1
    moving_average_update_rate: float = 1.0
    seed: int = 0


def _from_dict(cls, data):
    if isinstance(data, cls):
        return data
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in dict(data).items():
        if k not in fields:
            raise ValueError(f"unknown config key {k!r} for {cls.__name__}")
        ftype = fields[k].type
        nested = {
            "ObjectConfig": ObjectConfig, "CameraConfig": CameraConfig,
            "ObservationConfig": ObservationConfig,
            "TransitionConfig": TransitionConfig,
        }.get(str(ftype).replace("typing.", "").strip("'\""))
        kwargs[k] = _from_dict(nested, v) if nested and isinstance(
            v, dict) else v
    return cls(**kwargs)


def particle_config_from_dict(data) -> ParticleTrackerConfig:
    return _from_dict(ParticleTrackerConfig, data)


def gaussian_config_from_dict(data) -> GaussianTrackerConfig:
    return _from_dict(GaussianTrackerConfig, data)


def load_config(path: str):
    """Load a tracker config from JSON or YAML (type tagged by 'tracker')."""
    with open(path) as fh:
        text = fh.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml  # type: ignore
            data = yaml.safe_load(text)
        except ImportError as e:
            raise RuntimeError(
                "YAML config requires pyyaml; use JSON instead") from e
    else:
        data = json.loads(text)
    kind = data.pop("tracker", "particle")
    if kind == "particle":
        return particle_config_from_dict(data)
    if kind == "gaussian":
        return gaussian_config_from_dict(data)
    raise ValueError(f"unknown tracker type {kind!r}")
