"""Gaussian tracker facade.

Port of ``dbot_ros_tpu/trackers/gaussian.py``: the robust-Gaussian-filter
tracker with the particle tracker's user surface (initialize/track,
model-frame poses, EMA smoothing). Multi-object scenes run the joint
filter (state (K, 13), joint 12K-dim tangent covariance, min-over-objects
render). ``pixel_stride`` evaluates the update on a sparse pixel subset,
cutting render and update cost by the stride.

The tracker runs on the card: ``device=None`` means ``cuda``, and a
machine without CUDA raises. Pass ``device="cpu"`` to run on the CPU, as
the tests do. A ``track`` call reads nothing back from the device except,
during a hypothesis trial, all hypotheses' scores together once per
frame.

**The compiled step.** As the JAX tracker's two ``jax.jit`` steps, the
step and its frozen variant for trials are one CUDA graph each on the
card (utils/graphs.py; ``capture=False`` and the CPU run the same
functions eagerly through the same buffers). ``dt`` is a 0-d float32
buffer, so distinct intervals never recapture. As in the JAX tracker the
belief is not donated: a step copies the belief into the graph's
buffers and returns copies of its results, so a belief held across a
``track`` call stays as it was.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch.filters import rgf
from dbot_ros_tpu_torch.models import beam, occlusion, transition
from dbot_ros_tpu_torch.ops.raycast import raycast_depth
from dbot_ros_tpu_torch.trackers import base
from dbot_ros_tpu_torch.trackers.particle import (_host, build_camera,
                                                  build_meshes,
                                                  resolve_device)
from dbot_ros_tpu_torch.utils import graphs
from dbot_ros_tpu_torch.utils.camera import CameraModel, preprocess_depth
from dbot_ros_tpu_torch.utils.mesh import TriangleMesh
from dbot_ros_tpu_torch.utils.profiling import span

# at most this many hypotheses race in a trial
MAX_HYPOTHESES = 4


class GaussianTracker:
    """User-facing Gaussian tracker (one or more rigid objects) on
    ``device`` (default: ``cuda``; raises without it). Build from a
    config, or pass meshes and camera directly; they are moved to the
    device. ``capture`` (default: on a CUDA device) runs each step as a
    CUDA-graph replay; ``False`` runs it eagerly; ``True`` on the CPU
    raises."""

    def __init__(self, config: cfg.GaussianTrackerConfig,
                 mesh: Optional[TriangleMesh] = None,
                 camera: Optional[CameraModel] = None,
                 meshes: Optional[List[TriangleMesh]] = None, device=None,
                 capture=None):
        self.config = config
        self.device = resolve_device(device)
        self.capture = graphs.resolve_capture(self.device, capture)
        # the step (True) and its frozen variant (False), on one stream
        # and pool
        self.programs: dict = {}
        camera = camera if camera is not None else build_camera(
            config.camera)
        self.camera = camera.to(self.device)
        if meshes is None:
            meshes = [mesh] if mesh is not None else build_meshes(
                config.object)
        if not meshes:
            raise ValueError("gaussian tracker needs at least one mesh")
        self.meshes = [m.to(self.device) for m in meshes]
        self.mesh = self.meshes[0]
        self.num_objects = len(self.meshes)
        self._single = self.num_objects == 1

        obs = config.observation
        self.beam_params = beam.make_beam_params(
            tail_weight=obs.tail_weight, model_sigma=obs.model_sigma,
            sigma_factor=obs.sigma_factor, min_depth=obs.min_depth,
            max_depth=obs.max_depth, exponential_rate=obs.exponential_rate,
            device=self.device)
        tr = config.transition
        self.trans_params = transition.make_transition_params(
            tr.linear_acceleration_sigma, tr.angular_acceleration_sigma,
            tr.damping, device=self.device)

        # Sparse-pixel sensor subset. pixel_stride <= 0 → degrade to a
        # budget (ops/budget.rgf_pixel_stride): keeps the sigma-point
        # raycast bounded as objects and pixels grow.
        stride = int(config.pixel_stride)
        if stride <= 0:
            from dbot_ros_tpu_torch.ops.budget import rgf_pixel_stride
            stride = rgf_pixel_stride(
                self.camera.num_pixels,
                max(m.padded_triangles for m in self.meshes),
                self.num_objects, config.update_iterations)
        stride = max(stride, 1)
        self.pixel_stride = stride
        self._pixel_idx = (None if stride == 1 else torch.arange(
            0, self.camera.num_pixels, stride, device=self.device))
        self._rays = (self.camera.rays if self._pixel_idx is None
                      else self.camera.rays[self._pixel_idx])

        # Sigma-point render backend: "deferred" (default) routes the
        # sigma renders through the candidate pass
        # (ops/deferred.make_sigma_renderer), the exact raycast runs once
        # per iteration at the mean only; "exact" raycasts every sigma
        # pose against every triangle (the oracle path).
        if config.sigma_backend == "deferred":
            from dbot_ros_tpu_torch.ops.deferred import make_sigma_renderer
            self.render_fn = make_sigma_renderer(
                self.meshes, self.camera.rays, self.camera.height,
                self.camera.width, pixel_idx=self._pixel_idx,
                radius=config.sigma_radius,
                num_candidates=config.sigma_candidates)
        elif config.sigma_backend == "exact":
            self.render_fn = self._render_exact
        else:
            raise ValueError(
                f"unknown sigma_backend {config.sigma_backend!r} "
                "(expected 'deferred' or 'exact')")

        self._dt = 1.0 / config.camera.frame_rate
        self._frame_rate = float(config.camera.frame_rate)
        self._occ_params = (occlusion.make_occlusion_params(
            obs.p_occluded_visible, obs.p_occluded_occluded,
            obs.initial_occlusion_prob, device=self.device)
            if config.occlusion_memory else None)
        self.belief: Optional[rgf.GaussianBelief] = None
        self._smoothed = None
        self._trial = None

    def _render_exact(self, poses):
        """(S, 7) single-object | (S, K, 7) scene → (S, n_sub)."""
        if self._single:
            return raycast_depth(self.meshes[0], poses, self._rays)
        depth = None
        for k, m in enumerate(self.meshes):
            d = raycast_depth(m, poses[..., k, :], self._rays)
            depth = d if depth is None else torch.minimum(depth, d)
        return depth

    def _step(self, belief, z, dt, learn_world=True):
        """One filter step (``learn_world=False``: the trial's frozen
        variant) through its step program: ``belief``, the frame and
        ``dt`` (a float or a 0-d tensor, scaling the process noise and the
        occlusion memory's propagation) are copied in, the graph replayed,
        and copies of the results returned."""
        prog = self.programs.get(learn_world)
        if prog is None:
            prog = self.programs[learn_world] = graphs.StepProgram(
                self.device, self.capture,
                share=next(iter(self.programs.values()), None))
        bel = prog.keep("belief", belief)
        z = prog.keep("z", z)
        dt = prog.scalar("dt", dt)
        c = self.config

        def step():
            new, info = rgf.rgf_step(
                bel, z, render_fn=self.render_fn,
                trans_params=self.trans_params, dt=dt, bp=self.beam_params,
                iterations=c.update_iterations, trust_sigma=c.trust_sigma,
                lin_floor_pos=c.lin_floor_pos, lin_floor_rot=c.lin_floor_rot,
                lin_cap_pos=c.lin_cap_pos, lin_cap_rot=c.lin_cap_rot,
                bg_sigma=c.bg_sigma, occ_params=self._occ_params,
                occ_dt_frames=dt * self._frame_rate, learn_world=learn_world)
            return prog.keep("belief", new), prog.keep("info", info)

        new, info = prog.run("step", step)
        with span("dbot.step.copy_out"):
            return graphs.copy_out(new), graphs.copy_out(info)

    @property
    def centers(self):
        return torch.stack([m.center for m in self.meshes])

    @property
    def trial_active(self):
        """Number of racing init hypotheses, or None outside a trial
        (surfaced into FrameMetrics: per-frame latency multiplies by it
        during a trial)."""
        return len(self._trial["beliefs"]) if self._trial else None

    def _poses(self, poses):
        """Poses given as a tensor or array-like → float32 on the device."""
        if not isinstance(poses, torch.Tensor):
            poses = np.asarray(poses, np.float32)
        return torch.as_tensor(poses, dtype=torch.float32,
                               device=self.device)

    def _to_center(self, poses_model):
        if self._single:
            return base.to_center_frame(poses_model.reshape(7),
                                        self.mesh.center)
        return base.to_center_frame(
            poses_model.reshape(self.num_objects, 7), self.centers)

    def _frame(self, depth_image):
        """A depth image → the update's flat pixel subset."""
        with span("dbot.track.upload"):
            z = preprocess_depth(torch.as_tensor(
                depth_image, dtype=torch.float32,
                device=self.device).reshape(-1))
            return z if self._pixel_idx is None else z[self._pixel_idx]

    def _make_belief(self, pose_center, first_frame):
        c = self.config
        return rgf.init_belief(
            pose_center, num_pixels=self._rays.shape[0],
            first_frame=first_frame, pos_sigma=c.init_pos_sigma,
            rot_sigma=c.init_rot_sigma, vel_sigma=c.init_vel_sigma,
            background_depth=float(c.observation.max_depth),
            initial_occlusion_prob=(
                float(c.observation.initial_occlusion_prob)
                if c.occlusion_memory else None), device=self.device)

    def initialize(self, pose_model, first_frame=None, hypotheses=None,
                   hypothesis_logits=None, trial_frames: int = 6,
                   trial_switch_margin: float = 1.0,
                   reuse_background: bool = False,
                   keep_covariance: bool = False):
        """Set the initial pose(s); optionally race init hypotheses.

        ``hypotheses`` (H, 7) | (H, K, 7) model-frame poses (the
        automatic initializer's refined beams): a Gaussian is unimodal,
        so near-symmetric init twins get a short multi-hypothesis trial:
        every hypothesis (the best four by ``hypothesis_logits``) runs
        its own belief for the next ``trial_frames`` frames with the
        world model frozen; the best accumulated observation log-marginal
        (``RgfStepInfo.obs_loglik``) wins and the rest are dropped. The
        first hypothesis is published meanwhile and kept unless a
        challenger wins by ``trial_switch_margin`` nats per frame.

        ``first_frame`` seeds the background map. With two or more
        hypotheses (and no inherited map) the union of all candidate
        poses' predicted object regions is masked out of that seed: a
        pixel any hypothesis may cover says nothing about the scene
        behind it.

        ``reuse_background``: carry the incumbent belief's learned
        background map into the new belief(s) instead of re-seeding from
        ``first_frame`` (the recovery semantics: the world model persists
        across a re-initialization, only the object belief resets).

        ``keep_covariance``: carry the incumbent belief's covariance into
        the new belief(s) instead of the initial spread (a re-anchor,
        ``runtime.initializer.reanchor_tracker``: the pose was aligned on
        the newest frame, and a fresh spread over the stale background
        map throws the first step several mm off); the velocity is still
        reset to zero.
        """
        pose_center = self._to_center(self._poses(pose_model))
        hyp = None
        if hypotheses is not None:
            hyp = self._poses(hypotheses)
            if hyp.ndim == 2:
                hyp = hyp[:, None]
        inherited_bg = (self.belief.background
                        if reuse_background and self.belief is not None
                        else None)
        kept_cov = (self.belief.cov.clone()
                    if keep_covariance and self.belief is not None
                    else None)
        if first_frame is not None:
            first_frame = self._frame(first_frame)
        if first_frame is not None and inherited_bg is None \
                and hyp is not None and hyp.shape[0] >= 2:
            cand_poses = [pose_center] + [self._to_center(h) for h in hyp]
            covered = torch.zeros(first_frame.shape, dtype=torch.bool,
                                  device=self.device)
            for pc in cand_poses:
                pk = pc.reshape(self.num_objects, 7)
                for k, m in enumerate(self.meshes):
                    d = raycast_depth(m, pk[k], self._rays)
                    covered = covered | torch.isfinite(d)
            first_frame = torch.where(covered, float("nan"), first_frame)

        def build(pc):
            b = self._make_belief(pc, first_frame)
            if inherited_bg is not None:
                b = dataclasses.replace(b, background=inherited_bg)
            if kept_cov is not None:
                b = dataclasses.replace(b, cov=kept_cov)
            return b

        self.belief = build(pose_center)
        self._smoothed = pose_center
        self._trial = None
        if hyp is not None and hyp.shape[0] >= 2:
            order = (list(np.argsort(-_host(hypothesis_logits), kind="stable"))
                     if hypothesis_logits is not None
                     else list(range(hyp.shape[0])))[:MAX_HYPOTHESES]
            beliefs = [build(self._to_center(hyp[i])) for i in order]
            self._trial = {"beliefs": beliefs,
                           "scores": [0.0] * len(beliefs),
                           "left": int(trial_frames), "elapsed": 0,
                           "margin": float(trial_switch_margin)}

    def restore(self, belief: rgf.GaussianBelief):
        """Resume from a saved belief (runtime/checkpoint.py); ends a
        running trial. A checkpoint without an occlusion-memory leaf gets
        one at the initial prior when the memory is configured on, rather
        than silently running the memoryless filter."""
        if belief.occ_prior is None and self._occ_params is not None:
            belief = dataclasses.replace(belief, occ_prior=torch.full_like(
                belief.background,
                float(self.config.observation.initial_occlusion_prob)))
        self.belief = belief
        self._smoothed = belief.mean[..., :7]
        self._trial = None

    def hypothesis_means(self):
        """Model-frame mean poses (H, K, 7) of the racing hypotheses
        during a trial (slot 0, the published one, first), else of the
        belief (H = 1): what a re-anchor seeds from
        (``runtime.initializer.reanchor_tracker``)."""
        if self.belief is None:
            raise RuntimeError("call initialize(pose) first")
        beliefs = self._trial["beliefs"] if self._trial else [self.belief]
        means = torch.stack([b.mean[..., :7].reshape(self.num_objects, 7)
                             for b in beliefs])
        return base.to_model_frame(means, self.centers)

    def track(self, depth_image, dt=None):
        """One frame → (pose(s) in the model frame, RgfStepInfo).

        ``dt``: real interval since the previous frame in seconds, a
        float or a 0-d tensor (default 1/frame_rate); transition noise
        and the occlusion memory propagate by it."""
        if self.belief is None:
            raise RuntimeError("call initialize(pose) before track()")
        dt = self._dt if dt is None else dt
        if not isinstance(dt, torch.Tensor):
            dt = float(np.float32(dt))
        z = self._frame(depth_image)
        trial = self._trial
        if trial:
            infos = []
            for i, b in enumerate(trial["beliefs"]):
                # the world model stays frozen during a trial
                trial["beliefs"][i], info_i = self._step(
                    b, z, dt, learn_world=False)
                infos.append(info_i)
            # one host read for all hypotheses
            for i, s in enumerate(torch.stack(
                    [info_i.obs_loglik for info_i in infos]).tolist()):
                trial["scores"][i] += s
            trial["left"] -= 1
            trial["elapsed"] += 1
            if trial["left"] <= 0:
                # commit once, at trial end: the prior choice (slot 0)
                # holds unless a challenger wins the accumulated marginal
                # by the margin
                best = int(np.argmax(trial["scores"]))
                if best != 0 and (trial["scores"][best]
                                  - trial["scores"][0]
                                  < trial["margin"] * trial["elapsed"]):
                    best = 0
                self.belief = trial["beliefs"][best]
                info = infos[best]
                self._trial = None
            else:
                self.belief = trial["beliefs"][0]
                info = infos[0]
            # follow the held or winning hypothesis directly (an EMA
            # across hypotheses would average incompatible orientations)
            self._smoothed = self.belief.mean[..., :7]
        else:
            self.belief, info = self._step(self.belief, z, dt)
        with span("dbot.track.smooth"):
            self._smoothed = base.moving_average_pose(
                self._smoothed, self.belief.mean[..., :7],
                self.config.moving_average_update_rate)
            poses = base.to_model_frame(
                self._smoothed, self.mesh.center if self._single
                else self.centers)
        return poses, info

