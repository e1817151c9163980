"""Particle tracker facade + builder.

Port of ``dbot_ros_tpu/trackers/particle.py``: a host-side stateful
wrapper around the RBC-PF step that owns the belief, the random
generator, output smoothing, the model↔centre frame conversions
(``tracker.initialize(poses); tracker.track(depth)``) and the island
trial of racing init hypotheses.

The tracker runs on the card: ``device=None`` means ``cuda``, and a
machine without CUDA raises. Pass ``device="cpu"`` to run the kernels'
plain versions on the CPU, as the tests do.

**The compiled step.** As the JAX tracker's ``jax.jit`` step, a step
runs through a step program (utils/graphs.py): on the card, CUDA-graph
replays (``capture=None`` or ``True``); with ``capture=False``, and on
the CPU, the same functions eagerly through the same buffers. Each
coordinate block is two graphs with the fused sensor, the proposal with
the sensor's work before its one host read (``FusedSensor.plan_device``)
and, after the read picks the ladder's level, one graph per level for
the rest of the block (after the last block the step's summary too);
with another sensor one graph per block. ``dt`` is a 0-d float32 buffer,
so distinct intervals never recapture. The random numbers are drawn into
static buffers from the tracker's (or the island's) generator before the
replay, in the eager step's order, so the streams are the eager step's.

**The belief is donated**, as in the JAX tracker: a step overwrites the
buffers of the belief before it, and ``tracker.belief`` after a step *is*
those buffers. Whatever keeps a belief across a ``track`` call owns a
copy or reads it first (a checkpoint save reads it at once). A belief
set from outside (``initialize``, ``restore``, a re-initialization by the
watchdog or a command) is copied into the buffers by the next step and
never written; nothing recaptures. Only the belief is donated: the
StepInfo a step returns is copied out of the buffers and outlives the
next step, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch.filters import rbcpf
from dbot_ros_tpu_torch.models import beam, occlusion, transition
from dbot_ros_tpu_torch.models.image_loglik import image_loglik
from dbot_ros_tpu_torch.models.sensor import make_rb_sensor, render_scene
from dbot_ros_tpu_torch.ops import resample as rs
from dbot_ros_tpu_torch.ops.budget import xla_tri_chunk
from dbot_ros_tpu_torch.trackers import base
from dbot_ros_tpu_torch.utils import graphs, se3
from dbot_ros_tpu_torch.utils.camera import (CameraModel,
                                             default_kinect_camera,
                                             make_camera, preprocess_depth)
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh, load_obj
from dbot_ros_tpu_torch.utils.profiling import span

# at most this many hypotheses race as islands
MAX_ISLANDS = 4


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card. Never falls
    back to the CPU: without CUDA the default raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the tracker runs on the card by default; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return device


def build_camera(camera_cfg: cfg.CameraConfig, device=None) -> CameraModel:
    if camera_cfg.camera_matrix is None:
        return default_kinect_camera(camera_cfg.downsampling_factor,
                                     device=device)
    h, w = camera_cfg.resolution
    return make_camera(np.asarray(camera_cfg.camera_matrix, float), h, w,
                       camera_cfg.downsampling_factor, device=device)


def build_meshes(object_cfg: cfg.ObjectConfig,
                 device=None) -> List[TriangleMesh]:
    return [load_obj(p, center=object_cfg.center_object,
                     scale=object_cfg.scale, device=device)
            for p in object_cfg.mesh_paths()]


def island_generator(seed: int, slot: int, device) -> torch.Generator:
    """The random stream of island ``slot``: slot 0 is the tracker's own
    stream (seeded from ``seed`` alone), every other slot its own,
    seeded from ``(seed, slot)``."""
    gen = torch.Generator(device=device)
    if slot == 0:
        gen.manual_seed(seed)
    else:
        gen.manual_seed(int(np.random.SeedSequence(
            [int(seed) & 0xFFFFFFFF, slot]).generate_state(1)[0]))
    return gen


class ParticleTracker:
    """User-facing particle tracker (one or more rigid objects) on
    ``device`` (default: ``cuda``; raises without it). Build from a
    config, or pass meshes and camera directly; they are moved to the
    device. ``capture`` (default: on a CUDA device) runs each step as
    CUDA-graph replays; ``False`` runs it eagerly; ``True`` on the CPU
    raises."""

    def __init__(self, config: cfg.ParticleTrackerConfig,
                 meshes: Optional[List[TriangleMesh]] = None,
                 camera: Optional[CameraModel] = None, device=None,
                 capture=None):
        self.config = config
        self.device = resolve_device(device)
        self.capture = graphs.resolve_capture(self.device, capture)
        # one step program per island slot, kept across trials (slot 0:
        # the tracker's own generator), all on one stream and pool
        self.programs: dict = {}
        self._island_generators: list = []
        camera = camera if camera is not None else build_camera(
            config.camera)
        self.camera = camera.to(self.device)
        meshes = meshes if meshes is not None else build_meshes(
            config.object)
        if not meshes:
            raise ValueError("particle tracker needs at least one mesh")
        self.meshes = [m.to(self.device) for m in meshes]

        obs = config.observation
        self.beam_params = beam.make_beam_params(
            tail_weight=obs.tail_weight, model_sigma=obs.model_sigma,
            sigma_factor=obs.sigma_factor, min_depth=obs.min_depth,
            max_depth=obs.max_depth, exponential_rate=obs.exponential_rate,
            device=self.device)
        self.occ_params = occlusion.make_occlusion_params(
            obs.p_occluded_visible, obs.p_occluded_occluded,
            obs.initial_occlusion_prob, device=self.device)
        tr = config.transition
        self.trans_params = transition.make_transition_params(
            tr.linear_acceleration_sigma, tr.angular_acceleration_sigma,
            tr.damping, device=self.device)
        self.sensor = make_rb_sensor(
            self.meshes, self.camera, self.beam_params, self.occ_params,
            frame_rate=config.camera.frame_rate, backend=config.backend,
            device=self.device, **(config.backend_options or {}))
        self._dt = 1.0 / config.camera.frame_rate
        self.generator = island_generator(config.seed, 0, self.device)
        self.belief: Optional[rbcpf.ParticleBelief] = None
        self._smoothed = None  # (K, 7) centred-frame smoothed poses
        # multi-hypothesis island trial (see initialize())
        self._trial = None

    @property
    def centers(self):
        return torch.stack([m.center for m in self.meshes])  # (K, 3)

    @property
    def trial_active(self):
        """Number of racing island hypotheses, or None outside a trial
        (surfaced into FrameMetrics: per-frame latency multiplies by it
        during a trial)."""
        return len(self._trial["beliefs"]) if self._trial else None

    def _program(self, generator) -> graphs.StepProgram:
        """The step program of the island drawing from ``generator`` (its
        slot in the last trial), else slot 0's."""
        slot = next((i for i, g in enumerate(self._island_generators)
                     if g is generator), 0)
        prog = self.programs.get(slot)
        if prog is None:
            prog = self.programs[slot] = graphs.StepProgram(
                self.device, self.capture,
                share=next(iter(self.programs.values()), None))
        return prog

    def _score(self, generator, mean_state, z):
        """:meth:`_pose_score` through the island's step program."""
        prog = self._program(generator)
        mean_state = prog.keep("info.mean_state", mean_state)
        z = prog.keep("z", z)
        return prog.run("score", lambda: prog.keep(
            "score", self._pose_score(mean_state, z)))

    def _pose_score(self, mean_state, z_obs):
        """Chain-free pose score for the island race: an island's
        posterior-mean state re-evaluated against the frame with the
        occlusion chain reset to its initial prior. Racing on the
        filter's own mean loglik launders: within a few frames the chain
        marks a wrong basin's persistent misfit pixels as occluded, and a
        flipped pose's per-frame marginal overtakes the right one."""
        n_px = self.camera.num_pixels
        depth = render_scene(self.meshes, mean_state[None, :, :7],
                             self.camera.rays, xla_tri_chunk(1, n_px))
        occ0 = self.occ_params.initial_occlusion_prob.expand(1, n_px)
        ll, _ = image_loglik(depth, z_obs, occ0, self.beam_params,
                             self.occ_params, 1.0)
        return ll[0]

    def _poses(self, poses):
        """Poses given as a tensor or array-like → float32 on the device."""
        if not isinstance(poses, torch.Tensor):
            poses = np.asarray(poses, np.float32)
        return torch.as_tensor(poses, dtype=torch.float32,
                               device=self.device)

    def _make_belief(self, poses_center, generator=None):
        return rbcpf.init_belief(
            poses_center, self.config.evaluation_count,
            self.camera.num_pixels,
            float(self.occ_params.initial_occlusion_prob),
            sensor=self.sensor, generator=generator, device=self.device)

    def initialize(self, poses_model, hypotheses=None,
                   hypothesis_logits=None, trial_frames: int = 8,
                   trial_switch_margin: float = 2.0):
        """Set the initial object pose(s), in the original mesh frame, and
        re-seed the generator from ``config.seed``.

        ``hypotheses`` (H, 7) | (H, K, 7) model-frame poses (the
        automatic initializer's refined beams): with H ≥ 2 the best four
        by ``hypothesis_logits`` race as **separate island beliefs** for
        ``trial_frames`` frames. The best accumulated chain-free pose
        score (see ``_pose_score``) wins and the rest are dropped; the
        search argmax (slot 0) is published meanwhile and kept unless a
        challenger wins by ``trial_switch_margin`` nats per frame.
        Islands protect each basin from cross-hypothesis resampling
        while evidence accumulates: in one mixed cloud the first KL
        resample annihilates a hypothesis that arrived a few nats
        under-refined. Each island owns its occlusion map (the sensor
        updates a map in place) and draws from its own generator
        (``island_generator``). With fewer than two hypotheses they are
        ignored, as in the reference.
        """
        poses_model = self._poses(poses_model)
        if poses_model.ndim == 1:
            poses_model = poses_model[None]
        poses_center = base.to_center_frame(poses_model, self.centers)
        self.generator = island_generator(self.config.seed, 0, self.device)
        self._trial = None
        hyp = None
        if hypotheses is not None:
            hyp = self._poses(hypotheses)
            if hyp.ndim == 2:
                hyp = hyp[:, None]           # (H, 7) → (H, 1, 7)

        if hyp is not None and hyp.shape[0] >= 2:
            order = (list(np.argsort(-_host(hypothesis_logits),
                                     kind="stable"))
                     if hypothesis_logits is not None
                     else list(range(hyp.shape[0])))[:MAX_ISLANDS]
            generators = [island_generator(self.config.seed, i + 1,
                                           self.device) for i in order]
            self._island_generators = generators
            beliefs = [self._make_belief(
                base.to_center_frame(hyp[i], self.centers), g)
                for i, g in zip(order, generators)]
            self._trial = {"beliefs": beliefs, "generators": generators,
                           "scores": [0.0] * len(beliefs),
                           "left": int(trial_frames), "elapsed": 0,
                           "margin": float(trial_switch_margin)}
            self.belief = beliefs[0]
        else:
            self.belief = self._make_belief(poses_center, self.generator)
        self._smoothed = poses_center

    def restore(self, belief: rbcpf.ParticleBelief):
        """Resume from a saved belief (runtime/checkpoint.py); ends a
        running trial. The next step copies ``belief`` into the tracker's
        buffers, so ``belief`` itself stays as it was (unless it is the
        tracker's own, which each step overwrites)."""
        self._trial = None
        self.belief = belief
        self._smoothed = _mean_pose(belief)

    def hypothesis_means(self):
        """Model-frame mean poses (H, K, 7) of the racing island beliefs
        during a trial (slot 0, the published one, first), else of the
        belief (H = 1): what a re-anchor seeds from
        (``runtime.initializer.reanchor_tracker``)."""
        if self.belief is None:
            raise RuntimeError("call initialize(poses) first")
        beliefs = self._trial["beliefs"] if self._trial else [self.belief]
        return base.to_model_frame(
            torch.stack([_mean_pose(b) for b in beliefs]), self.centers)

    def _step(self, belief, z, dt, generator):
        """One filter step of ``belief`` through the step program of
        ``generator``'s island (see the module docstring): the same
        result, bit for bit, as ``rbcpf.rbcpf_step`` drawing from
        ``generator``. Returns the belief as the program's buffers
        (donated: the next step overwrites them) and the StepInfo as
        copies out of them, which outlive the next step."""
        prog = self._program(generator)
        bel = prog.keep("belief", belief)
        z = prog.keep("z", z)
        dt = prog.scalar("dt", dt)
        P, K = bel.states.shape[:2]
        resamples = self.config.max_kl_divergence < rbcpf.NEVER_RESAMPLE_KL
        with span("dbot.step.noise"):
            noise = rbcpf.draw_noise([rbcpf.BlockNoise(
                prog.buffer(f"e1.{b}", (P, 6)),
                prog.buffer(f"e2.{b}", (P, 6)),
                prog.buffer(f"u.{b}", ()) if resamples else None)
                for b in range(K)], generator)
        info = None
        for b in range(K):
            info = self._block(prog, b, bel, z, dt, noise[b])
        with span("dbot.step.copy_out"):
            info = graphs.copy_out(info)
        return dataclasses.replace(bel), info

    def _block(self, prog, b, bel, z, dt, nb):
        """Coordinate block ``b`` of a step (``rbcpf.program_block``): with
        the fused sensor, one graph for the proposal and the sensor's work
        before its host read, the read (the level), and the level's graph
        for the rest; with another sensor one graph. The belief's buffers
        are updated in place; after the last block the step's StepInfo is
        returned."""
        sensor = self.sensor
        last = b == bel.num_objects - 1

        def rest(states, plan):
            loglik, occ_post = rbcpf.sense(sensor, plan, states,
                                           bel.occlusion, z, dt, last)
            if b == 0:
                old = torch.zeros_like(bel.log_weights)
                res = torch.zeros((), dtype=torch.bool, device=self.device)
            else:
                old, res = prog["carry.old_loglik"], prog["carry.resampled"]
            new, old, res, kl = rbcpf.weigh_block(
                dataclasses.replace(bel, states=states), loglik, occ_post,
                old, res, last, self.config.max_kl_divergence,
                rbcpf.occlusion_gather(sensor), u=nb.u)
            prog.keep("belief", new)
            if last:
                return prog.keep("info", rbcpf.summarize(new, loglik, res,
                                                         kl))
            prog.keep("carry", {"old_loglik": old, "resampled": res})
            return None

        return rbcpf.program_block(prog, sensor, b, bel, z, dt,
                                   self.trans_params, nb, rest)

    def track(self, depth_image, dt=None):
        """One frame → (poses (K, 7) in the model frame, StepInfo).

        ``dt``: real interval since the previous frame in seconds (default
        1/frame_rate); transition noise and the occlusion chain scale
        with it.
        """
        if self.belief is None:
            raise RuntimeError("call initialize(poses) before track()")
        with span("dbot.track.upload"):
            z = preprocess_depth(torch.as_tensor(
                depth_image, dtype=torch.float32,
                device=self.device).reshape(-1))
        dt = float(np.float32(self._dt if dt is None else dt))
        trial = self._trial
        if trial:
            infos, scores = [], []
            for i, b in enumerate(trial["beliefs"]):
                gen = trial["generators"][i]
                trial["beliefs"][i], info_i = self._step(b, z, dt, gen)
                scores.append(self._score(gen, info_i.mean_state, z))
                infos.append(info_i)
            # one host read for all islands
            for i, s in enumerate(torch.stack(scores).tolist()):
                trial["scores"][i] += s
            trial["left"] -= 1
            trial["elapsed"] += 1
            if trial["left"] <= 0:
                # commit once, at trial end: the search argmax holds
                # unless a challenger wins the accumulated score by the
                # margin
                best = int(np.argmax(trial["scores"]))
                if best != 0 and (trial["scores"][best]
                                  - trial["scores"][0]
                                  < trial["margin"] * trial["elapsed"]):
                    best = 0
                self.belief = trial["beliefs"][best]
                self.generator = trial["generators"][best]
                info = infos[best]
                self._trial = None
            else:
                self.belief = trial["beliefs"][0]
                info = infos[0]
        else:
            self.belief, info = self._step(self.belief, z, dt,
                                           self.generator)
        with span("dbot.track.smooth"):
            self._smoothed = base.moving_average_pose(
                self._smoothed, info.mean_state[:, :7],
                self.config.moving_average_update_rate)
            poses = base.to_model_frame(self._smoothed, self.centers)
        return poses, info


def _mean_pose(belief: rbcpf.ParticleBelief):
    """The weighted mean pose (K, 7) of a particle belief, centred frame."""
    ln, _ = rs.normalize_log_weights(belief.log_weights)
    return se3.states_mean(belief.states, torch.exp(ln))[:, :7]


def _host(x):
    """A tensor or array-like as a float numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)
