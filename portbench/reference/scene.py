"""The benchmark's scene: the tracked objects' meshes, the camera, the
trajectories and the exact renderer that makes every frame.

Plain PyTorch and NumPy on top of the frozen copies in ``frozen/``; it
imports nothing of the port. The ellipsoid's generator is a frozen copy
of the arithmetic of ``dbot_ros_tpu_torch/utils/mesh.py``
``icosphere_mesh`` (subdivision, midpoint cache, normalisation)
returning raw arrays, which are then stretched into a tri-axial
ellipsoid: a sphere hides rotation. The box is the occluder's
(``frozen/mesh.py`` ``_box_arrays``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .frozen import raycast, se3
from .frozen.camera import default_kinect_camera, make_camera
from .frozen.mesh import _box_arrays, make_mesh, parse_obj


def icosphere_arrays(subdivisions: int):
    """Unit icosphere (20 · 4^s triangles): vertices (V, 3) float64 and
    faces (T, 3) int64, as ``icosphere_mesh`` builds them."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        cache: dict = {}
        verts = list(map(tuple, v))
        newf = []

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (np.array(verts[i]) + np.array(verts[j])) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(tuple(m))
            return cache[key]

        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            newf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.array(verts, np.float64)
        f = np.array(newf, np.int64)
    return v, f


def object_obj_text(mesh_spec: dict) -> str:
    """A tracked object as Wavefront OBJ text. ``kind`` ``ellipsoid`` (the
    default): an icosphere of ``subdivisions`` stretched to
    ``semi_axes_m``; ``box``: an axis-aligned box of side lengths
    ``size_m`` centred at the origin. Vertices are rounded to float32 and
    written with 17 digits, so every parser reads the same float32
    values."""
    kind = mesh_spec.get("kind", "ellipsoid")
    if kind == "ellipsoid":
        v, f = icosphere_arrays(int(mesh_spec["subdivisions"]))
        v = v * np.asarray(mesh_spec["semi_axes_m"], np.float64)
    elif kind == "box":
        v, f = _box_arrays(*[float(s) for s in mesh_spec["size_m"]])
    else:
        raise ValueError(f"unknown mesh kind {kind!r}")
    v = v.astype(np.float32).astype(np.float64)
    lines = [f"v {x:.17g} {y:.17g} {z:.17g}" for x, y, z in v]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in f]
    return "\n".join(lines) + "\n"


def object_mesh(obj_text: str, center: bool, device):
    """The frozen TriangleMesh of the OBJ text (``center`` as the
    configuration's ``center_object``)."""
    v, f = parse_obj(obj_text)
    return make_mesh(v, f, center=center, device=device)


def camera_for(camera_cfg: dict, device, native: bool = False):
    """The configuration's camera (``camera_matrix`` null: Kinect-class
    VGA), downsampled as configured or, with ``native``, at full
    resolution."""
    factor = 1 if native else int(camera_cfg["downsampling_factor"])
    if camera_cfg.get("camera_matrix") is None:
        return default_kinect_camera(factor, device=device)
    h, w = camera_cfg["resolution"]
    return make_camera(np.asarray(camera_cfg["camera_matrix"], float), h, w,
                       factor, device=device)


def to_model_frame(pose_center, center):
    """Centred-frame pose (..., 7) → model-frame pose (the trackers'
    published frame): t − R(q)·c."""
    t = se3.pose_trans(pose_center) - se3.quat_rotate(
        se3.pose_quat(pose_center), center.expand(pose_center.shape[:-1]
                                                  + (3,)))
    return se3.make_pose(t, se3.pose_quat(pose_center))


def to_center_frame(pose_model, center):
    """Model-frame pose (..., 7) → centred-frame pose: t + R(q)·c."""
    t = se3.pose_trans(pose_model) + se3.quat_rotate(
        se3.pose_quat(pose_model), center.expand(pose_model.shape[:-1]
                                                 + (3,)))
    return se3.make_pose(t, se3.pose_quat(pose_model))


# ---------------------------------------------------------------------------
# Trajectories: periodic in ``period`` frames, so playback wraps without a
# jump
# ---------------------------------------------------------------------------

def trajectory(params: dict, rng: np.random.Generator, period: int,
               rate_hz: float):
    """Model-frame poses (period, 7) float64 of one period.

    Translation: ``depth_m`` ahead of the camera plus a sway of
    ``amplitude_m`` per axis at integer ``harmonics`` of the period, plus
    ``offset_m`` (x, y, z; zero if not given, drawing nothing).
    Rotation: ``sway`` (a rotation vector of ``amplitude_rad`` per axis at
    integer harmonics, about a base orientation) or ``spin`` (``turns``
    whole turns a period about the fixed skew ``axis``, after the base
    orientation). Phases and the base orientation come from ``rng``."""
    t = np.arange(period, dtype=np.float64)
    tr = params["translation"]
    amp = np.asarray(tr["amplitude_m"], np.float64)
    harm = np.asarray(tr["harmonics"], np.float64)
    ph = rng.uniform(0.0, 2.0 * math.pi, 3)
    pos = amp[None] * np.sin(2.0 * math.pi * harm[None] * t[:, None] / period
                             + ph[None])
    pos[:, 2] += float(params["depth_m"])
    if "offset_m" in params:
        pos += np.asarray(params["offset_m"], np.float64)[None]

    base = rng.normal(size=3)
    base *= float(params["rotation"].get("base_rad", 0.5)) / np.linalg.norm(
        base)
    rot = params["rotation"]
    if rot["kind"] == "sway":
        ra = np.asarray(rot["amplitude_rad"], np.float64)
        rh = np.asarray(rot["harmonics"], np.float64)
        rph = rng.uniform(0.0, 2.0 * math.pi, 3)
        rv = ra[None] * np.sin(2.0 * math.pi * rh[None] * t[:, None] / period
                               + rph[None])
    elif rot["kind"] == "spin":
        axis = np.asarray(rot["axis"], np.float64)
        axis /= np.linalg.norm(axis)
        ang = 2.0 * math.pi * float(rot["turns"]) * t / period
        rv = ang[:, None] * axis[None]
    else:
        raise ValueError(f"unknown rotation kind {rot['kind']!r}")
    q_base = se3.so3_exp_quat(torch.as_tensor(base, dtype=torch.float64))
    q_move = se3.so3_exp_quat(torch.as_tensor(rv, dtype=torch.float64))
    q = se3.quat_multiply(q_move, q_base.expand(period, 4))
    q = q * torch.where(q[:, :1] < 0, -1.0, 1.0)
    return np.concatenate([pos, q.numpy()], axis=1)


def occluder_poses(params: dict, period: int, rate_hz: float):
    """The occluding bar's model-frame poses (period, 7) and a mask of the
    frames it is in view: a triangle wave across ``±span_m`` at
    ``speed_m_s`` and ``depth_m``, during ``frames`` [start, stop) of
    each period."""
    start, stop = params["frames"]
    span, speed = float(params["span_m"]), float(params["speed_m_s"])
    t = np.arange(period, dtype=np.float64)
    s = (t - start) * speed / rate_hz                  # metres travelled
    lap = 4.0 * span
    ph = np.mod(s, lap)
    x = np.where(ph < 2.0 * span, -span + ph, 3.0 * span - ph)
    poses = np.zeros((period, 7))
    poses[:, 0] = x
    poses[:, 2] = float(params["depth_m"])
    poses[:, 3] = 1.0
    on = (t >= start) & (t < stop)
    return poses, on


def render(meshes_poses, rays, background_m: float):
    """Exact z-depth (F, N) of several meshes at their poses over ``rays``
    (float32), the background plane at ``background_m`` where nothing is
    hit. ``meshes_poses``: list of (frozen mesh, (F, 7) poses, (F,) bool
    mask of the frames it is in view or None)."""
    depth = None
    for mesh, poses, on in meshes_poses:
        d = raycast.raycast_depth(mesh, poses, rays)
        if on is not None:
            d = torch.where(on[:, None], d, float("inf"))
        depth = d if depth is None else torch.minimum(depth, d)
    return torch.where(torch.isfinite(depth), depth, float(background_m))


def render_clipped(mesh, poses, camera, radius: float, background_m: float,
                   margin_px: int = 2):
    """Exact z-depth (F, H, W) at full camera resolution, the raycast
    clipped to each frame's image box of the mesh's bounding sphere
    (``radius`` about the pose's translation), the background plane
    elsewhere."""
    F = poses.shape[0]
    H, W = camera.height, camera.width
    K = camera.camera_matrix.double().cpu().numpy()
    rays = camera.rays.reshape(H, W, 3)
    out = torch.full((F, H, W), float(background_m), dtype=torch.float32,
                     device=rays.device)
    p = poses.detach().cpu().numpy()
    for i in range(F):
        x, y, z = p[i, :3]
        zc = max(z - radius, 1e-3)
        u0 = int(math.floor(K[0, 2] + K[0, 0] * (x - radius) / zc)) - margin_px
        u1 = int(math.ceil(K[0, 2] + K[0, 0] * (x + radius) / zc)) + margin_px
        v0 = int(math.floor(K[1, 2] + K[1, 1] * (y - radius) / zc)) - margin_px
        v1 = int(math.ceil(K[1, 2] + K[1, 1] * (y + radius) / zc)) + margin_px
        u0, v0 = max(u0, 0), max(v0, 0)
        u1, v1 = min(u1 + 1, W), min(v1 + 1, H)
        if u0 >= u1 or v0 >= v1:
            continue
        box = rays[v0:v1, u0:u1].reshape(-1, 3)
        d = raycast.raycast_depth(mesh, poses[i:i + 1], box)[0]
        d = torch.where(torch.isfinite(d), d, float(background_m))
        out[i, v0:v1, u0:u1] = d.reshape(v1 - v0, u1 - u0)
    return out


def box_mesh(size_m, device):
    """An axis-aligned box (the occluder) of side lengths ``size_m``."""
    v, f = _box_arrays(*[float(s) for s in size_m])
    return make_mesh(v, f, center=False, device=device)


def preprocess_u16(depth_mm: np.ndarray, downsampling: int) -> np.ndarray:
    """uint16 millimetres → float32 metres by strided downsampling, 0 →
    NaN: the camera transport's conversion (``ri::to_eigen``), written
    out plainly."""
    d = depth_mm[::downsampling, ::downsampling]
    oh, ow = depth_mm.shape[0] // downsampling, depth_mm.shape[1] // downsampling
    d = d[:oh, :ow]
    out = d.astype(np.float32) * np.float32(1e-3)
    out[d <= 0] = np.float32(np.nan)
    return out


def preprocess(depth):
    """A depth frame as the trackers take it: flat float32 on its device,
    non-positive and non-finite values NaN."""
    depth = torch.as_tensor(depth, dtype=torch.float32).reshape(-1)
    bad = ~torch.isfinite(depth) | (depth <= 0.0)
    return torch.where(bad, float("nan"), depth)
