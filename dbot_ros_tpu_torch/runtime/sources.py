"""Depth-frame sources: recorded replay, simulation and the live camera.

Port of ``dbot_ros_tpu/runtime/sources.py``.
:class:`ReplaySource` replays an ``.npz``/``.npy`` depth stack (the file
format is the reference's, so a recording made by either package replays
in the other); :class:`SyntheticSource` renders a scripted ground-truth
trajectory through the production raycaster and adds sensor noise and
dropout, drawn from a ``torch.Generator`` seeded from ``seed``. Sources
iterate ``Frame(index, depth, ground_truth)``.

The live-camera path: :class:`OracleSource` renders through the
independent oracle raycaster with Kinect-class artifacts,
:class:`U16CameraAdapter` puts frames through the uint16 sensor transport
and the native conversion, and :class:`ThreadedSource` decouples a camera
thread from the tracking loop through the native drop-oldest frame ring.

As the reference jits both renders, each render here is the one graph of
its own step program (``utils/graphs.compiled``): captured and replayed
on the card (``capture`` None or True), eager on the CPU and with
``capture=False``. The random fields are drawn before the replay, the
render's inputs are copied into the program's buffers, and a render
returns a copy of its output buffer.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from dbot_ros_tpu_torch.native import FrameRing, preprocess_depth_u16
from dbot_ros_tpu_torch.ops.raycast import raycast_depth, raycast_oracle
from dbot_ros_tpu_torch.trackers.base import to_center_frame
from dbot_ros_tpu_torch.utils import graphs
from dbot_ros_tpu_torch.utils.camera import CameraModel, make_camera
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh


@dataclasses.dataclass
class Frame:
    index: int
    depth: np.ndarray          # (N,) or (H, W) float32, NaN = invalid
    ground_truth: Optional[np.ndarray] = None  # (K, 7) model-frame poses
    # frames dropped since the last one; None = pull source
    skipped: Optional[int] = None


class ReplaySource:
    """Replay a recorded depth sequence from .npz/.npy.

    Accepted layouts:
      * .npz with ``depth`` (T, H, W) and optional ``poses`` (T, K, 7);
      * .npy with just the (T, H, W) depth stack.
    Depth in meters, NaN/0/negative = invalid. Frames stay numpy arrays
    on the host; the tracker moves each to its device.
    """

    def __init__(self, path: str):
        if str(path).endswith(".npz"):
            data = np.load(path)
            self.depth = np.asarray(data["depth"], np.float32)
            self.poses = (np.asarray(data["poses"], np.float32)
                          if "poses" in data else None)
        else:
            self.depth = np.asarray(np.load(path), np.float32)
            self.poses = None
        if self.depth.ndim != 3:
            raise ValueError(f"depth stack must be (T, H, W), "
                             f"got {self.depth.shape}")

    def __len__(self):
        return self.depth.shape[0]

    def __iter__(self) -> Iterator[Frame]:
        for t in range(len(self)):
            gt = self.poses[t] if self.poses is not None else None
            yield Frame(t, self.depth[t], gt)


def record_npz(path: str, depth_stack, poses=None):
    """Write a replay file: ``depth`` (T, H, W) and optional ``poses``."""
    arrays = {"depth": np.asarray(depth_stack, np.float32)}
    if poses is not None:
        arrays["poses"] = np.asarray(poses, np.float32)
    np.savez_compressed(path, **arrays)


class SyntheticSource:
    """Render a scripted ground-truth trajectory into noisy depth frames.

    ``trajectory_fn(t: int) → (K, 7)`` model-frame poses (host-side).
    Rendering and noise run on the camera's device; frames come out as
    flat (N,) numpy arrays, as in the reference. ``capture``: the render's
    graph (see the module docstring).
    """

    def __init__(self, meshes, camera: CameraModel, trajectory_fn,
                 num_frames: int, noise_sigma: float = 0.003,
                 dropout_prob: float = 0.0, background_depth: float = 2.0,
                 seed: int = 0, capture=None):
        if isinstance(meshes, TriangleMesh):
            meshes = [meshes]
        self.camera = camera
        self.device = camera.rays.device
        self.meshes = [m.to(self.device) for m in meshes]
        self.trajectory_fn = trajectory_fn
        self.num_frames = num_frames
        self.noise_sigma = noise_sigma
        self.dropout_prob = dropout_prob
        self.background_depth = background_depth
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._render = graphs.compiled(self._render_plain, self.device,
                                       capture)

    def __len__(self):
        return self.num_frames

    def render(self, poses_model):
        """(K, 7) model-frame poses → noisy flat depth (N,) on the device:
        the noise and the dropout's uniforms drawn from the generator
        (in that order, each only where used), then the render's graph."""
        n = self.camera.num_pixels
        noise = drop = None
        if self.noise_sigma > 0:
            noise = torch.randn(n, generator=self.generator,
                                device=self.device)
        if self.dropout_prob > 0:
            drop = torch.rand(n, generator=self.generator,
                              device=self.device)
        return self._render(poses_model, noise, drop).clone()

    def _render_plain(self, poses_model, noise, drop):
        depth = None
        for k, mesh in enumerate(self.meshes):
            pc = to_center_frame(poses_model[k], mesh.center)
            d = raycast_depth(mesh, pc, self.camera.rays)
            depth = d if depth is None else torch.minimum(depth, d)
        z = torch.where(torch.isfinite(depth), depth,
                        float(self.background_depth))
        if noise is not None:
            z = z + self.noise_sigma * noise
        if drop is not None:
            z = torch.where(drop < self.dropout_prob, float("nan"), z)
        return z

    def __iter__(self) -> Iterator[Frame]:
        for t in range(self.num_frames):
            poses = np.asarray(self.trajectory_fn(t), np.float32)
            if poses.ndim == 1:
                poses = poses[None]
            z = self.render(torch.as_tensor(poses, device=self.device))
            yield Frame(t, z.cpu().numpy(), poses)


def scale_camera(camera: CameraModel, factor: int) -> CameraModel:
    """A camera with ``factor``× the resolution and intrinsics: the native
    sensor grid whose strided downsample lands back on ``camera``."""
    K = camera.camera_matrix.detach().cpu().numpy().astype(np.float64)
    K[:2, :] *= factor
    return make_camera(K, camera.height * factor, camera.width * factor,
                       device=camera.rays.device)


class OracleDraws(NamedTuple):
    """The five random fields of one :class:`OracleSource` frame, each a
    flat ``(N,)`` float32 tensor: standard normals for the depth noise and
    uniforms in [0, 1) for the Bernoulli draws (a draw fires where
    ``u < p``)."""

    normal: torch.Tensor      # depth noise
    dropout: torch.Tensor     # pixel dropout, p = the frame's dropout
    edge_hit: torch.Tensor    # edge artifact at a discontinuity
    mode: torch.Tensor        # flying pixel (< 0.5) or shadow (NaN)
    neighbour: torch.Tensor   # vertical (< 0.5) or lateral neighbour


class OracleSource:
    """Independent-renderer evaluation source (no inverse crime).

    Port of the reference's ``OracleSource``: like :class:`SyntheticSource`
    but rendered through ``ops.raycast.raycast_oracle``, which shares no
    code with the production raycaster or the kernels the trackers use,
    plus the papers' stress protocols:

      * ``occluder`` + ``occluder_fn(t) → (7,)``: an untracked occluder
        mesh rendered in front of the scene (min-combined; not part of
        the ground truth);
      * ``dropout_frames=(a, b)``: ``dropout_prob`` applies only inside
        that frame window (sensor-dropout bursts);
      * ``noise_sigma``: Gaussian depth noise;
      * ``edge_artifacts``: probability that a pixel next to a depth
        discontinuity (> ``edge_threshold`` m against a 4-neighbour)
        misbehaves: half the draws give NaN (edge shadow), the other half
        a neighbour's depth (flying pixel);
      * ``quantize_mm``: depth rounded to whole millimetres, the u16
        transport's quantization (pair with :class:`U16CameraAdapter`).

    Rendering runs on the camera's device; :meth:`render` takes the
    frame's five random fields as :class:`OracleDraws` (the parity tests
    inject the JAX package's), and iteration draws them from a
    ``torch.Generator`` seeded by ``seed``. Frames come out as flat
    ``(N,)`` numpy arrays on the host. ``capture``: the render's graph
    (see the module docstring).
    """

    def __init__(self, meshes, camera: CameraModel, trajectory_fn,
                 num_frames: int, noise_sigma: float = 0.003,
                 background_depth: float = 2.0, seed: int = 0,
                 occluder: TriangleMesh = None, occluder_fn=None,
                 dropout_prob: float = 0.0, dropout_frames=None,
                 edge_artifacts: float = 0.0, edge_threshold: float = 0.03,
                 quantize_mm: bool = False, capture=None):
        if isinstance(meshes, TriangleMesh):
            meshes = [meshes]
        self.camera = camera
        self.device = camera.rays.device
        self.meshes = [m.to(self.device) for m in meshes]
        self.trajectory_fn = trajectory_fn
        self.num_frames = num_frames
        self.noise_sigma = noise_sigma
        self.background_depth = background_depth
        self.occluder = (occluder.to(self.device) if occluder is not None
                         else None)
        self.occluder_fn = occluder_fn
        self.dropout_prob = dropout_prob
        self.dropout_frames = dropout_frames
        self.edge_artifacts = edge_artifacts
        self.edge_threshold = edge_threshold
        self.quantize_mm = quantize_mm
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._render = graphs.compiled(self._render_plain, self.device,
                                       capture)

    def __len__(self):
        return self.num_frames

    def draw(self) -> OracleDraws:
        """One frame's random fields from the source's generator."""
        n = self.camera.num_pixels

        def uniform():
            return torch.rand(n, generator=self.generator,
                              device=self.device)

        normal = torch.randn(n, generator=self.generator, device=self.device)
        return OracleDraws(normal, uniform(), uniform(), uniform(),
                           uniform())

    def render(self, poses_model, occ_pose, p_drop: float,
               draws: OracleDraws):
        """(K, 7) model-frame poses → flat depth (N,) on the device,
        through the render's graph (``p_drop`` becomes a 0-d tensor)."""
        p_drop = torch.full((), float(p_drop), device=self.device)
        return self._render(poses_model, occ_pose, p_drop, draws).clone()

    def _render_plain(self, poses_model, occ_pose, p_drop, draws):
        cam = self.camera
        depth = None
        for k, mesh in enumerate(self.meshes):
            pc = to_center_frame(poses_model[k], mesh.center)
            d = raycast_oracle(mesh, pc, cam.rays)
            depth = d if depth is None else torch.minimum(depth, d)
        if self.occluder is not None:
            depth = torch.minimum(
                depth, raycast_oracle(self.occluder, occ_pose, cam.rays))
        z = torch.where(torch.isfinite(depth), depth,
                        float(self.background_depth))
        if self.noise_sigma > 0:
            z = z + self.noise_sigma * draws.normal
        if self.edge_artifacts > 0:
            hw = (cam.height, cam.width)
            z2 = z.reshape(hw)
            shift = [torch.roll(z2, s, dims=a)
                     for a in (0, 1) for s in (1, -1)]
            edge = torch.zeros_like(z2, dtype=torch.bool)
            for nb in shift:
                edge = edge | (torch.abs(z2 - nb) > self.edge_threshold)
            hit = draws.edge_hit.reshape(hw) < self.edge_artifacts
            mode = draws.mode.reshape(hw) < 0.5
            # the neighbour choice has its own draw, or the shadow/fly
            # select would mask one arm
            nb_v = draws.neighbour.reshape(hw) < 0.5
            fly = torch.where(nb_v, shift[0], shift[2])
            z2 = torch.where(edge & hit,
                             torch.where(mode, fly, float("nan")), z2)
            z = z2.reshape(-1)
        z = torch.where(draws.dropout < p_drop, float("nan"), z)
        if self.quantize_mm:
            z = torch.round(z * 1000.0) / 1000.0
        return z

    def frame_inputs(self, t: int):
        """Frame ``t``'s (K, 7) poses (host), occluder pose and dropout
        probability."""
        poses = np.asarray(self.trajectory_fn(t), np.float32)
        if poses.ndim == 1:
            poses = poses[None]
        if self.occluder_fn is not None:
            occ = np.asarray(self.occluder_fn(t), np.float32)
        else:
            occ = np.array([0.0, 0.0, -10.0, 1.0, 0.0, 0.0, 0.0], np.float32)
        p_drop = self.dropout_prob
        if self.dropout_frames is not None:
            a, b = self.dropout_frames
            p_drop = p_drop if a <= t < b else 0.0
        return poses, occ, float(p_drop)

    def __iter__(self) -> Iterator[Frame]:
        for t in range(self.num_frames):
            poses, occ, p_drop = self.frame_inputs(t)
            z = self.render(torch.as_tensor(poses, device=self.device),
                            torch.as_tensor(occ, device=self.device),
                            p_drop, self.draw())
            yield Frame(t, z.cpu().numpy(), poses)


class ThreadedSource:
    """Push-based frame ingestion decoupled from tracking.

    Port of the reference's ``ThreadedSource``: a producer (an internal
    thread replaying ``inner``, or any camera thread calling :meth:`push`)
    writes frames into the native drop-oldest :class:`FrameRing`;
    iteration pops the LATEST frame and reports how many were dropped
    since the last pop (``Frame.skipped``, counted by index continuity:
    ring overwrites at push time and stale frames skipped at pop time).

    Modes:
      * ``ThreadedSource(inner, rate_hz=...)``: replay an iterable source
        from a producer thread at ``rate_hz`` (None = flat out);
      * ``ThreadedSource(frame_shape=(H, W))``: externally driven, a
        camera callback calls ``push(depth, ...)`` and ``close()``.

    ``native=False`` takes the ring's plain version.
    """

    def __init__(self, inner=None, frame_shape=None, capacity: int = 8,
                 rate_hz: Optional[float] = None, native: bool = True):
        if inner is None and frame_shape is None:
            raise ValueError("need an inner source or a frame_shape")
        self.inner = inner
        self.rate_hz = rate_hz
        self.capacity = capacity
        self.native = native
        self.skipped_total = 0
        self._gt = {}
        self._gt_lock = threading.Lock()
        self._max_pushed = -1
        self._last_idx = -1
        self._done = threading.Event()
        self._started = False
        self._ring = None
        if frame_shape is not None:
            self._ring = FrameRing(tuple(frame_shape), capacity, native)

    def push(self, depth, index: Optional[int] = None, ground_truth=None):
        """Producer side (one thread): enqueue a frame, drop-oldest.
        Without ``index`` the frame takes the largest index pushed + 1."""
        depth = np.ascontiguousarray(depth, np.float32)
        if self._ring is None:
            self._ring = FrameRing(depth.shape, self.capacity, self.native)
        if index is None:
            index = self._max_pushed + 1
        self._max_pushed = max(self._max_pushed, int(index))
        if ground_truth is not None:
            with self._gt_lock:
                self._gt[int(index)] = np.asarray(ground_truth)
        self._ring.push(depth, float(index))

    @property
    def last_index(self) -> int:
        """Index of the last frame popped (-1 before the first): with
        ``skipped_total``, every index up to it is either popped or
        counted as skipped."""
        return self._last_idx

    def close(self):
        """Producer side: no more frames will be pushed."""
        self._done.set()

    def wait_closed(self, timeout: Optional[float] = None) -> bool:
        """Wait until the producer is done; False on timeout."""
        return self._done.wait(timeout)

    def _producer(self):
        try:
            for fr in self.inner:
                self.push(fr.depth, fr.index, fr.ground_truth)
                if self.rate_hz:
                    time.sleep(1.0 / self.rate_hz)
        finally:
            self._done.set()

    def __iter__(self) -> Iterator[Frame]:
        if self.inner is not None and not self._started:
            self._started = True
            threading.Thread(target=self._producer, daemon=True).start()
        while True:
            item = self._ring.pop_latest() if self._ring is not None \
                else None
            if item is None:
                if self._done.is_set() and (
                        self._ring is None or len(self._ring) == 0):
                    return
                time.sleep(0.001)
                continue
            depth, stamp, _ring_skips = item
            idx = int(stamp)
            skipped = max(idx - self._last_idx - 1, 0)
            self._last_idx = idx
            self.skipped_total += skipped
            with self._gt_lock:
                gt = self._gt.pop(idx, None)
                # drop the ground truths of dropped frames (in place: the
                # producer may be inserting concurrently)
                for k in [k for k in self._gt if k < idx]:
                    del self._gt[k]
            yield Frame(idx, depth, gt, skipped=skipped)


class U16CameraAdapter:
    """The reference's camera transport pipeline, end to end.

    Wraps a native-resolution source of float-metre frames and applies
    what ``RosCameraDataProvider`` + ``ri::to_eigen`` do to a Kinect
    stream: float metres → uint16 millimetres (quantization, 0 = invalid)
    → the native ``preprocess_depth_u16`` (strided downsample, mm → m,
    0 → NaN). The inner source renders at ``downsampling ×`` the tracker
    camera's resolution (see :func:`scale_camera`); ground truth passes
    through.
    """

    def __init__(self, inner, downsampling: int, native: bool = True):
        self.inner = inner
        self.downsampling = int(downsampling)
        self.native = native

    def __len__(self):
        return len(self.inner)

    def convert(self, depth) -> np.ndarray:
        """One float-metre frame → the downsampled frame the tracker sees."""
        d = np.asarray(depth, np.float32)
        if d.ndim == 1:
            cam = getattr(self.inner, "camera", None)
            if cam is None:
                raise ValueError(
                    "U16CameraAdapter needs (H, W) frames, or an inner "
                    "source with a .camera to reshape flat frames")
            d = d.reshape(cam.height, cam.width)
        mm = np.round(d * 1000.0)
        mm = np.where(np.isfinite(mm) & (mm > 0) & (mm < 65536),
                      mm, 0.0).astype(np.uint16)
        return preprocess_depth_u16(mm, self.downsampling,
                                    native=self.native)

    def __iter__(self) -> Iterator[Frame]:
        for fr in self.inner:
            yield Frame(fr.index, self.convert(fr.depth), fr.ground_truth,
                        getattr(fr, "skipped", None))
