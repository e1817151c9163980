"""The one traffic generator: every mix is a data file of parameters
(``portbench/traffic/<name>.json``) that this module reads.

A mix fixes the loop (``closed``: the next frame when the loop asks for
it; ``open``: a camera thread on a fixed schedule at ``rate_hz``), the
period of the playback in frames, the resolution frames are made at
(``tracker``: the configuration's downsampled camera, float32 metres;
``native``: full resolution, uint16 millimetres through the camera
transport), each tracked object's trajectory (``motion`` for one object,
``motions`` for K, one per object: ``core/spec.py``), the sensor noise,
an occluder, a dropout burst and the warm-up length. Everything is drawn
from the run's seed: object 0's trajectory from the ``trajectory``
stream, object k >= 1's from ``trajectory.<k>``. The frames are rendered
on the device by the reference's exact renderer, every object and the
occluder in one scene, and handed over from host memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.core import spec
from portbench.reference import scene

RENDER_CHUNK = 32       # frames a call of the renderer


@dataclasses.dataclass
class Traffic:
    """One period of frames and their ground truth."""

    loop: str                      # "closed" | "open"
    rate_hz: float                 # the camera's rate (open loop, and dt)
    period: int
    warmup_frames: int
    truth: np.ndarray              # (period, 7) model-frame poses, float32;
    #                                (period, K, 7) with K > 1 objects
    frames: np.ndarray             # (period, H, W) float32 m | uint16 mm
    native: bool                   # frames are uint16 at full resolution
    downsampling: int

    @property
    def objects(self) -> int:
        return 1 if self.truth.ndim == 2 else self.truth.shape[1]

    def poses(self, i: int) -> np.ndarray:
        """Frame ``i``'s true model-frame poses, (K, 7)."""
        return self.truth[i % self.period].reshape(self.objects, 7)


def sub_seed(seed: int, tag: str) -> np.random.SeedSequence:
    """An independent stream for one use of the run's seed."""
    return np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
         *tag.encode()])


def torch_generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(sub_seed(seed, tag).generate_state(1, np.uint64)[0]
                      >> np.uint64(1)))
    return g


def make(params: dict, config: dict, obj_texts, seed: int,
         device) -> Traffic:
    """The mix ``params`` for the configuration ``config`` (its camera)
    and the meshes ``obj_texts`` (OBJ texts, one per tracked object, in
    the order of the mix's motions, as ``spec.objects`` has checked
    them) from ``seed``, rendered on ``device``."""
    motions = spec.motions(params)
    period = int(params["period_frames"])
    rate = float(params["rate_hz"])
    native = params["resolution"] == "native"
    cam_cfg = config["camera"]
    camera = scene.camera_for(cam_cfg, device, native=native)
    truths = [scene.trajectory(
        motion, np.random.default_rng(sub_seed(
            seed, "trajectory" if k == 0 else f"trajectory.{k}")),
        period, rate) for k, motion in enumerate(motions)]
    truths_t = [torch.as_tensor(t, dtype=torch.float32, device=device)
                for t in truths]
    meshes = [scene.object_mesh(text, center=False, device=device)
              for text in obj_texts]
    bg = float(params["background_m"])
    if native:
        mesh, truth_t = meshes[0], truths_t[0]
        radius = float(np.linalg.norm(
            mesh.vertices.detach().cpu().numpy(), axis=1).max())
        depth = scene.render_clipped(mesh, truth_t, camera, radius, bg)
        depth = depth.reshape(period, -1)
    else:
        parts = [(m, t, None) for m, t in zip(meshes, truths_t)]
        occ = params.get("occluder")
        if occ:
            poses, on = scene.occluder_poses(occ, period, rate)
            parts.append((scene.box_mesh(occ["size_m"], device),
                          torch.as_tensor(poses, dtype=torch.float32,
                                          device=device),
                          torch.as_tensor(on, device=device)))
        chunk = RENDER_CHUNK
        depth = torch.cat([
            scene.render([(m, p[i:i + chunk],
                           None if on is None else on[i:i + chunk])
                          for m, p, on in parts], camera.rays, bg)
            for i in range(0, period, chunk)])
    gen = torch_generator(seed, "noise", device)
    sigma = float(params["noise_sigma_m"])
    depth = depth + sigma * torch.randn(depth.shape, generator=gen,
                                        device=device)
    drop = params.get("dropout")
    if drop:
        start, stop = drop["frames"]
        u = torch.rand((stop - start, depth.shape[1]), generator=gen,
                       device=device)
        burst = depth[start:stop]
        depth[start:stop] = torch.where(u < float(drop["share"]),
                                        float("nan"), burst)
    shape = (period, camera.height, camera.width)
    if native:
        mm = torch.round(depth * 1000.0)
        mm = torch.where(torch.isfinite(mm) & (mm > 0) & (mm < 65536), mm,
                         0.0)
        frames = mm.to(torch.int32).cpu().numpy().astype(np.uint16)
    else:
        frames = depth.cpu().numpy().astype(np.float32)
    return Traffic(loop=params["loop"], rate_hz=rate, period=period,
                   warmup_frames=int(params["warmup_frames"]),
                   truth=(truths[0] if len(truths) == 1
                          else np.stack(truths, axis=1)).astype(np.float32),
                   frames=np.ascontiguousarray(frames.reshape(shape)),
                   native=native,
                   downsampling=int(cam_cfg["downsampling_factor"]))


def tracker_frame(traffic: Traffic, i: int, convert=None) -> np.ndarray:
    """Frame ``i`` of the playback as the tracker takes it: the stored
    float32 frame, or the native frame put through ``convert`` (uint16
    millimetres, downsampling → float32 metres)."""
    f = traffic.frames[i % traffic.period]
    if not traffic.native:
        return f
    convert = convert or scene.preprocess_u16
    return convert(f, traffic.downsampling)

