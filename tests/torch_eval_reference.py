"""Fixtures for the port's accuracy suite: the same frames on both sides.

Renders the accuracy scenes with the JAX package's ``OracleSource`` and
runs the JAX trackers on exactly those frames, so that the PyTorch port
(``dbot_ros_tpu_torch/runtime/eval_suite.py``, which has no JAX) can be
held to the JAX tracker on the same frames. Writes
``tests/fixtures/torch_eval/``:

* ``eval/<scenario>.npz``: the six scenarios of
  ``benchmarks/eval_suite.py`` (:180-181), 45 frames at 40×30, rendered
  with its ``seed=0``; ``sensor_u16`` holds the frames after
  ``U16CameraAdapter``, which the tracker sees;
* ``production/<protocol>.npz``: the 10k certification's four protocols
  (``benchmarks/tpu_session26.py``), 60 frames at 80×60;
* ``jax_reference.json``: the rule the port is held to (``bound_rule``,
  from the constants below), and per leg the JAX tracker's metrics for
  each tracker seed of its rule (1-10 for the particle filters, 1-3 for
  the deterministic Gaussian filter), their mean and spread.

Each ``.npz`` holds ``depth`` (F, H, W) float32, the ground-truth
model-frame ``poses`` (F, K, 7) float32, the intrinsics ``camera_matrix``
(3, 3) and ``height``/``width``.

Run on the CPU (the 244 runs take ~24,000 CPU-seconds; a run's result
is cached in ``--work`` and not repeated):

    python tests/torch_eval_reference.py [--jobs 5]

The legs run on the committed frames; a missing frame file is rendered
first (delete one to render it anew). Mind the memory: an
``eval/two_obj/pf-xla`` run holds up to ~9 GB, a 10,000-particle run
~1 GB, the others ~1.5 GB or less.

``--spread LEG,... --seeds A-B`` runs only those JAX legs over other
seeds into ``--work``'s ``spread.json``, leaving the reference alone.
``--lockstep LEG [--seed S] [--frames N]`` runs a PF leg's JAX step and
the port's side by side on its frames, the port fed JAX's draws.
``--first-weights LEG [--seed S]`` holds frame 0's logliks and
resampling parents of the two packages side by side.

Pytest does not collect this file (its name does not start with
``test_``); the tests import its scene definitions, which run nothing and
set no JAX option when imported.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_eval")
REFERENCE = os.path.join(FIXTURES, "jax_reference.json")

EVAL_SCENARIOS = ("nominal", "occluder", "dropout", "fast_rot", "two_obj",
                  "sensor_u16")
EVAL_ESTIMATORS = ("pf-xla", "pf-deferred", "pf-pallas", "rgf")
EVAL_FRAMES = 45
EVAL_PARTICLES = 512
EVAL_TWO_OBJ_PF_PARTICLES = 2048
EVAL_RENDER_SEED = 0

PRODUCTION_PROTOCOLS = ("nominal", "occluder", "dropout", "fast_rot")
PRODUCTION_FRAMES = 60
PRODUCTION_PARTICLES = 10_000
PRODUCTION_RENDER_SEED = 3
PRODUCTION_RGF_PROTOCOLS = ("nominal", "occluder")

# The rule the port is held to. These constants are its one source: the
# reference writes them into jax_reference.json's ``bound_rule``, which
# eval_suite reads. Particle-filter legs: seeds 1-10 on each side, and a
# leg fails metric m when the port's mean is worse than JAX's by more
# than the margin at α = 0.001 in a one-sided Welch test,
#     mean_p − mean_j > δ_m + T·sqrt(s_p²/n_p + s_j²/n_j)   (ddof 1),
# with T the one-sided 0.999 quantile of Student's t at the conservative
# Welch df, min(n_p, n_j) − 1 = 9 (scipy.stats.t.ppf(0.999, 9) = 4.2968).
# The Gaussian filter is deterministic (JAX sd 0 over its seeds): its
# legs keep the floor over JAX's mean and the 2 cm gate on the worst
# position error where JAX's mean is under it.
PF_SEEDS = tuple(range(1, 11))
RGF_SEEDS = (1, 2, 3)
ALPHA = 0.001
T_QUANTILE = 4.297
MARGIN = {"pos_rmse_m": 1.0e-3, "rot_rmse_rad": 0.02, "pos_max_m": 2.0e-3}
FLOOR = {"pos_rmse_m": 1.0e-3, "rot_rmse_rad": 0.02}
POS_MAX_LIMIT_M = 0.02
METRICS = ("pos_rmse_m", "rot_rmse_rad", "pos_max_m")
PF_ESTIMATORS = ("pf-xla", "pf-deferred", "pf-pallas")


def bound_rule():
    """``jax_reference.json``'s ``bound_rule``: per rule its legs'
    estimators and seeds and its constants (``eval_suite.judge``)."""
    return {
        "two_sample": {
            "estimators": list(PF_ESTIMATORS), "seeds": list(PF_SEEDS),
            "alpha": ALPHA, "df": len(PF_SEEDS) - 1,
            "t": T_QUANTILE, "margin": dict(MARGIN),
            "fails_when": "mean_p - mean_j > margin + t * sqrt(s_p^2/n_p "
                          "+ s_j^2/n_j), s the sample sd (ddof 1)",
            "report_over_m": POS_MAX_LIMIT_M,
        },
        "deterministic": {
            "estimators": ["rgf"], "seeds": list(RGF_SEEDS),
            "floor": dict(FLOOR), "pos_max_limit_m": POS_MAX_LIMIT_M,
            "fails_when": "mean_p > mean_j + floor; pos_max_m: mean_p > "
                          "limit where mean_j < limit",
        },
    }


def leg_rule(leg):
    """The name of the rule in ``bound_rule()`` that judges ``leg``."""
    return ("deterministic" if leg.split("/")[2] == "rgf"
            else "two_sample")


def leg_names():
    """Every leg as ``set/scenario/estimator``, production first."""
    legs = [f"production/{p}/pf-pallas" for p in PRODUCTION_PROTOCOLS]
    legs += [f"production/{p}/rgf" for p in PRODUCTION_RGF_PROTOCOLS]
    legs += [f"eval/{s}/{e}" for s in EVAL_SCENARIOS
             for e in EVAL_ESTIMATORS]
    return legs


def leg_seeds(leg):
    return bound_rule()[leg_rule(leg)]["seeds"]


def leg_particles(leg):
    set_name, scenario, estimator = leg.split("/")
    if estimator == "rgf":
        return None
    if set_name == "production":
        return PRODUCTION_PARTICLES
    if scenario == "two_obj":
        return EVAL_TWO_OBJ_PF_PARTICLES
    return EVAL_PARTICLES


def leg_config(leg):
    """The tracker configuration of a leg, as both packages build it.

    ``eval`` legs: ``benchmarks/eval_suite.py:138-176`` (``make_tracker``);
    ``production`` PF legs: ``benchmarks/tpu_session26.py:114-125``;
    ``production`` Gaussian legs: ``benchmarks/tpu_session30.py:59-64``.
    """
    set_name, scenario, estimator = leg.split("/")
    ang = 6.0 if scenario == "fast_rot" else 2.5
    conf = {
        "estimator": estimator,
        "observation": {"model_sigma": 0.005, "sigma_factor": 0.0},
        "transition": {"linear_acceleration_sigma": 0.4,
                       "angular_acceleration_sigma": ang, "damping": 6.0},
        "meshes": (["l_shape", "box(0.05, 0.07, 0.03)"]
                   if scenario == "two_obj" else ["l_shape"]),
    }
    if estimator == "rgf":
        conf.update(update_iterations=6, trust_sigma=1.5)
        return conf
    backend = estimator.replace("pf-", "")
    options = {}
    if set_name == "eval" and backend == "pallas":
        options = {"num_candidates": 4, "radius": 3}
    conf.update(backend=backend, evaluation_count=leg_particles(leg),
                max_kl_divergence=0.8, backend_options=options)
    if backend == "pallas":
        # what only the JAX side adds on the CPU: Pallas's interpreter
        # (automatic off the TPU), 16-pixel blocks for the production
        # legs (tpu_session26.py:119-120; 4,800 pixels pad to 4,800 with
        # 16 or 64)
        conf["jax_backend_options"] = dict(
            options, interpret=True,
            **({"nb": 16} if set_name == "production" else {}))
    return conf


# ------------------------------------------------------------------ scenes
# The ``eval`` set: benchmarks/eval_suite.py:46-135, copied (importing
# that file sets XLA_FLAGS and JAX's platform).

def eval_scene():
    """(camera, L-shaped mesh, occluder bar): eval_suite.py:46-54."""
    from dbot_ros_tpu.utils.camera import make_camera
    from dbot_ros_tpu.utils.mesh import box_mesh, l_shape_mesh

    K = np.array([[44.0, 0, 20], [0, 44.0, 15], [0, 0, 1.0]])
    cam = make_camera(K, 30, 40)
    return cam, l_shape_mesh(), box_mesh(0.03, 0.30, 0.02)


def scene_meshes(scenario, mesh):
    """eval_suite.py:57-62."""
    from dbot_ros_tpu.utils.mesh import box_mesh

    if scenario == "two_obj":
        return [mesh, box_mesh(0.05, 0.07, 0.03)]
    return [mesh]


def _start():
    import jax.numpy as jnp

    from dbot_ros_tpu.utils import se3
    return jnp.concatenate([jnp.array([0.0, 0.0, 0.55]),
                            se3.quat_identity()])


def eval_trajectory(kind, start):
    """eval_suite.py:65-98."""
    import jax.numpy as jnp

    from dbot_ros_tpu.utils import se3

    def pose_at(t):
        if kind == "two_obj":
            ang = 0.02 * t
            q0 = se3.quat_multiply(
                se3.so3_exp_quat(jnp.array([0.0, ang, 0.0])), start[3:7])
            p0 = start.at[0].add(0.0015 * t)
            p1 = jnp.array([0.13 - 0.006 * t, 0.01, 0.49])
            q1 = se3.quat_multiply(
                se3.so3_exp_quat(jnp.array([0.015 * t, 0.0, 0.0])),
                start[3:7])
            return jnp.stack([jnp.concatenate([p0[:3], q0]),
                              jnp.concatenate([p1, q1])])
        if kind == "fast_rot":
            ang = 0.145 * t
            axis = jnp.array([0.5, 0.8, 0.33])
            axis = axis / jnp.linalg.norm(axis)
            q = se3.so3_exp_quat(axis * ang)
            p = start.at[0].add(0.001 * t)
        else:
            ang = 0.03 * t
            q = se3.so3_exp_quat(jnp.array([0.0, ang, 0.0]))
            p = start.at[0].add(0.0015 * t).at[1].add(
                0.02 * np.sin(0.08 * t))
        return jnp.concatenate(
            [p[:3], se3.quat_multiply(q, start[3:7])])[None]

    return pose_at


def eval_source(kind, frames=EVAL_FRAMES, seed=EVAL_RENDER_SEED):
    """eval_suite.py:101-135 (``make_source``)."""
    from dbot_ros_tpu.runtime.sources import (OracleSource,
                                              U16CameraAdapter,
                                              scale_camera)

    cam, mesh, occluder = eval_scene()
    traj = eval_trajectory(kind, _start())
    meshes = scene_meshes(kind, mesh)
    if kind == "two_obj":
        return OracleSource(meshes, cam, traj, num_frames=frames,
                            noise_sigma=0.003, seed=seed)
    if kind == "sensor_u16":
        native = scale_camera(cam, 4)
        inner = OracleSource(mesh, native, traj, num_frames=frames,
                             noise_sigma=0.003, seed=seed,
                             edge_artifacts=0.15, quantize_mm=True)
        return U16CameraAdapter(inner, downsampling=4)
    kw = {}
    if kind == "occluder":
        def occ_fn(t):
            x = -0.14 + 0.012 * max(0, t - 8)
            return np.array([x, 0.0, 0.45, 1, 0, 0, 0], np.float32)
        kw = dict(occluder=occluder, occluder_fn=occ_fn)
    elif kind == "dropout":
        kw = dict(dropout_prob=0.5, dropout_frames=(12, 22))
    return OracleSource(mesh, cam, traj, num_frames=frames,
                        noise_sigma=0.003, seed=seed, **kw)


# The ``production`` set: benchmarks/tpu_session26.py:73-111, copied
# (importing that file runs its session).

def production_scene():
    """(camera, L-shaped mesh, occluder bar): tpu_session26.py:73-75."""
    from dbot_ros_tpu.utils.camera import default_kinect_camera
    from dbot_ros_tpu.utils.mesh import box_mesh, l_shape_mesh

    return default_kinect_camera(8), l_shape_mesh(), box_mesh(0.03, 0.30,
                                                              0.02)


def production_trajectory(kind, start):
    """tpu_session26.py:79-93 (``traj_nominal``, ``traj_fast_rot``)."""
    import jax.numpy as jnp

    from dbot_ros_tpu.utils import se3

    def traj_nominal(t):
        ang = 0.03 * t
        q = se3.so3_exp_quat(jnp.array([0.0, ang, 0.0]))
        p = start.at[0].add(0.0015 * t).at[1].add(0.02 * np.sin(0.08 * t))
        return jnp.concatenate([p[:3], se3.quat_multiply(q, start[3:7])])[
            None]

    def traj_fast_rot(t):
        ang = 0.145 * t
        axis = jnp.array([0.5, 0.8, 0.33])
        axis = axis / jnp.linalg.norm(axis)
        q = se3.so3_exp_quat(axis * ang)
        p = start.at[0].add(0.001 * t)
        return jnp.concatenate([p[:3], se3.quat_multiply(q, start[3:7])])[
            None]

    return traj_fast_rot if kind == "fast_rot" else traj_nominal


def production_occ_fn(t):
    """tpu_session26.py:96-99: the bar sweeps over frames 8..40."""
    x = -0.14 + 0.009 * max(0, t - 8)
    return np.array([x, 0.0, 0.45, 1, 0, 0, 0], np.float32)


def production_source(kind, frames=PRODUCTION_FRAMES,
                      seed=PRODUCTION_RENDER_SEED):
    """tpu_session26.py:102-111 (``make_src``)."""
    from dbot_ros_tpu.runtime.sources import OracleSource

    cam, mesh, occluder = production_scene()
    kw = {}
    if kind == "occluder":
        kw = dict(occluder=occluder, occluder_fn=production_occ_fn)
    elif kind == "dropout":
        kw = dict(dropout_prob=0.5, dropout_frames=(15, 28))
    return OracleSource(mesh, cam, production_trajectory(kind, _start()),
                        num_frames=frames, noise_sigma=0.003, seed=seed,
                        **kw)


def source(set_name, scenario, frames=None):
    if set_name == "eval":
        return eval_source(scenario, frames or EVAL_FRAMES)
    return production_source(scenario, frames or PRODUCTION_FRAMES)


def tracker_camera(set_name):
    return (eval_scene() if set_name == "eval" else production_scene())[0]


def render_frames(set_name, scenario, frames=None):
    """(depth (F, H, W) float32, poses (F, K, 7) float32) as the tracker
    sees them."""
    cam = tracker_camera(set_name)
    depth, poses = [], []
    for fr in source(set_name, scenario, frames):
        depth.append(np.asarray(fr.depth, np.float32).reshape(
            cam.height, cam.width))
        poses.append(np.asarray(fr.ground_truth, np.float32).reshape(-1, 7))
    return np.stack(depth), np.stack(poses)


def fixture_path(set_name, scenario, root=FIXTURES):
    return os.path.join(root, set_name, f"{scenario}.npz")


def write_fixture(set_name, scenario):
    depth, poses = render_frames(set_name, scenario)
    cam = tracker_camera(set_name)
    path = fixture_path(set_name, scenario)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path, depth=depth, poses=poses,
        camera_matrix=np.asarray(cam.camera_matrix, np.float32),
        height=np.int32(cam.height), width=np.int32(cam.width))
    return path


# ------------------------------------------------------------------- legs

def make_tracker(leg, seed):
    """The JAX tracker of a leg with tracker seed ``seed``."""
    import dataclasses

    from dbot_ros_tpu import config as cfg

    set_name, scenario, estimator = leg.split("/")
    if set_name == "eval":
        sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
        import eval_suite

        cam, mesh, _ = eval_scene()
        tracker = eval_suite.make_tracker(estimator, cam, mesh,
                                          leg_particles(leg), scenario)
        # make_tracker fixes seed=1; the seed is read at initialize only
        tracker.config = dataclasses.replace(tracker.config, seed=seed)
        return tracker
    cam, mesh, _ = production_scene()
    c = leg_config(leg)
    obs = cfg.ObservationConfig(**c["observation"])
    trans = cfg.TransitionConfig(**c["transition"])
    if estimator == "rgf":
        from dbot_ros_tpu.trackers.gaussian import GaussianTracker
        conf = cfg.GaussianTrackerConfig(
            observation=obs, transition=trans, seed=seed,
            update_iterations=c["update_iterations"],
            trust_sigma=c["trust_sigma"])
        return GaussianTracker(conf, meshes=[mesh], camera=cam)
    from dbot_ros_tpu.trackers.particle import ParticleTracker
    # tpu_session26.py:119-120: Pallas in interpret mode on the CPU
    conf = cfg.ParticleTrackerConfig(
        observation=obs, transition=trans,
        evaluation_count=c["evaluation_count"],
        max_kl_divergence=c["max_kl_divergence"], backend="pallas",
        seed=seed, backend_options={"interpret": True, "nb": 16})
    return ParticleTracker(conf, meshes=[mesh], camera=cam)


def lockstep(leg, seed, frames):
    """The JAX tracker's filter step and the port's (on the CPU) over a
    PF leg's first ``frames`` fixture frames, the port fed the draws the
    JAX step takes from its key: the two differ by their random streams
    alone otherwise. Yields per frame ``(port belief, port StepInfo, port
    sensor, JAX belief, JAX StepInfo, JAX sensor)``."""
    import functools

    import jax
    import jax.numpy as jnp
    import torch

    from dbot_ros_tpu.filters import rbcpf as jrbcpf
    from dbot_ros_tpu.utils.camera import preprocess_depth as jpre
    from dbot_ros_tpu_torch.filters import rbcpf
    from dbot_ros_tpu_torch.runtime import eval_suite
    from dbot_ros_tpu_torch.utils.camera import preprocess_depth as ppre
    from tests.test_torch_tracker import replayed_noise

    set_name, scenario, _ = leg.split("/")
    path = fixture_path(set_name, scenario)
    data = np.load(path)
    jt = make_tracker(leg, seed)
    pt = eval_suite.make_tracker(leg_config(leg), seed,
                                 eval_suite.fixture_camera(path, "cpu"),
                                 "cpu")
    jt.initialize(data["poses"][0])
    pt.initialize(data["poses"][0])
    jbel, pbel = jt.belief, pt.belief
    jstep = jax.jit(functools.partial(
        jrbcpf.rbcpf_step, loglik_fn=jt.sensor, trans_params=jt.trans_params,
        max_kl_divergence=jt.config.max_kl_divergence))
    dt = np.float32(1.0 / 30.0)
    for depth in data["depth"][:frames]:
        noise = replayed_noise(jbel.key, pbel.num_objects,
                               pbel.num_particles)
        jbel, jinfo = jstep(jbel, jpre(jnp.asarray(depth).reshape(-1)),
                            dt=jnp.float32(dt))
        pbel, pinfo = rbcpf.rbcpf_step(
            pbel, ppre(torch.as_tensor(depth).reshape(-1)), pt.sensor,
            pt.trans_params, float(dt),
            max_kl_divergence=pt.config.max_kl_divergence, noise=noise)
        yield pbel, pinfo, pt.sensor, jbel, jinfo, jt.sensor


def _main_lockstep(leg, seed, frames):
    """Per frame: the largest gap of the two means and the particles
    whose states differ by over 1e-4 (re-parented at a CDF tie)."""
    for f, (pbel, pinfo, _, jbel, jinfo, _) in enumerate(
            lockstep(leg, seed, frames)):
        gap = np.abs(pinfo.mean_state.numpy()
                     - np.asarray(jinfo.mean_state)).max()
        moved = int((np.abs(pbel.states.numpy() - np.asarray(jbel.states))
                     .reshape(pbel.num_particles, -1).max(1) > 1e-4).sum())
        print(f"frame {f:3d}  mean gap {gap:.2e}  re-parented {moved}",
              flush=True)


def _main_first_weights(leg, seed):
    """Frame 0 of a PF leg in both packages from the same belief and
    JAX's draws: the sensors' logliks on the same proposed states, the
    weights' total variation, and the parents each package's systematic
    resampler gives for the same log weights (and float64's)."""
    import jax.numpy as jnp
    import torch

    from dbot_ros_tpu.ops import resample as jres
    from dbot_ros_tpu.utils.camera import preprocess_depth as jpre
    from dbot_ros_tpu_torch.filters import rbcpf
    from dbot_ros_tpu_torch.ops import resample as pres
    from dbot_ros_tpu_torch.runtime import eval_suite
    from dbot_ros_tpu_torch.utils.camera import preprocess_depth as ppre
    from tests.test_torch_tracker import replayed_noise

    set_name, scenario, _ = leg.split("/")
    path = fixture_path(set_name, scenario)
    data = np.load(path)
    jt = make_tracker(leg, seed)
    pt = eval_suite.make_tracker(leg_config(leg), seed,
                                 eval_suite.fixture_camera(path, "cpu"),
                                 "cpu")
    jt.initialize(data["poses"][0])
    pt.initialize(data["poses"][0])
    jb, pb = jt.belief, pt.belief
    P = pb.num_particles
    nb = replayed_noise(jb.key, 1, P)[0]
    states = rbcpf.propose_block(pb.states, 0, 1 / 30, pt.trans_params, nb,
                                 None)
    z = data["depth"][0].reshape(-1)
    pl, _ = pt.sensor(states, pb.occlusion, ppre(torch.as_tensor(z)),
                      torch.tensor(1 / 30), commit=False)
    jl, _ = jt.sensor(jnp.asarray(states.numpy()), jb.occlusion,
                      jpre(jnp.asarray(z)), jnp.float32(1 / 30))
    pl, jl = pl.numpy(), np.asarray(jl)

    def weights(ll):
        w = np.exp(ll - ll.max())
        return w / w.sum()

    u = float(nb.u)
    pos = (np.arange(P) + u) / P
    ln = jres.normalize_log_weights(jnp.asarray(jl))[0]
    jpar = np.asarray(jres.sorted_searchsorted_left(
        jnp.cumsum(jnp.exp(ln)), jnp.asarray(pos, jnp.float32)))
    ppar = pres.systematic_indices(torch.as_tensor(jl), P, u=u).numpy()
    par64 = np.searchsorted(np.cumsum(weights(jl.astype(np.float64))), pos)
    print(f"loglik gap {np.abs(pl - jl).max():.4g} nats (values "
          f"{jl.min():.1f} to {jl.max():.1f}); weights' total variation "
          f"{np.abs(weights(pl) - weights(jl)).sum():.3g}; parents from "
          f"the same log weights: JAX/port differ in "
          f"{int((jpar != ppar).sum())}, JAX/float64 in "
          f"{int((jpar != par64).sum())} of {P}", flush=True)


def leg_metrics(run, scenario, frames):
    """eval_suite.py:220-238: RMSE over every frame, the worst position
    error over frames ≥ F//3; ``two_obj`` rotation modulo the box's
    symmetry group for object 1, the naive one beside it."""
    from dbot_ros_tpu.utils.se3 import box_symmetry_quats

    sym = [None, box_symmetry_quats()] if scenario == "two_obj" else None
    rec = {
        "pos_rmse_m": run.position_rmse(),
        "rot_rmse_rad": run.rotation_rmse(sym),
        "pos_max_m": float(run.position_errors()[frames // 3:].max()),
    }
    if scenario == "two_obj":
        rec["rot_rmse_naive"] = run.rotation_rmse()
    return rec


def run_leg(leg, seed):
    """One JAX run of a leg on its fixture; returns its metrics."""
    from dbot_ros_tpu.runtime import node
    from dbot_ros_tpu.runtime.sources import ReplaySource

    set_name, scenario, _ = leg.split("/")
    t0 = time.time()
    src = ReplaySource(fixture_path(set_name, scenario))
    tracker = make_tracker(leg, seed)
    run = node.run(tracker, src)
    rec = leg_metrics(run, scenario, len(src))
    rec["seed"] = seed
    rec["wall_s"] = time.time() - t0
    return rec


def _summary(runs):
    keys = [k for k in runs[0] if k not in ("seed", "wall_s")]
    mean = {k: float(np.mean([r[k] for r in runs])) for k in keys}
    sd = {k: float(np.std([r[k] for r in runs], ddof=1))
          if len(runs) > 1 else None for k in keys}
    return mean, sd


def aggregate(results):
    """Per leg: its runs, their mean and spread, and its rule
    (``results``: leg → runs)."""
    legs = {}
    for leg in leg_names():
        runs = sorted(results[leg], key=lambda r: r["seed"])
        mean, sd = _summary(runs)
        set_name, scenario, estimator = leg.split("/")
        legs[leg] = {
            "set": set_name, "scenario": scenario, "estimator": estimator,
            "frames": (EVAL_FRAMES if set_name == "eval"
                       else PRODUCTION_FRAMES),
            "particles": leg_particles(leg), "config": leg_config(leg),
            "rule": leg_rule(leg), "seeds": [r["seed"] for r in runs],
            "runs": runs, "mean": mean, "sd": sd,
        }
    return legs


def _git_commit():
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def _force_cpu():
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    return jax


def _main_leg(leg, seed, out):
    _force_cpu()
    rec = run_leg(leg, seed)
    with open(out, "w") as fh:
        json.dump(rec, fh)
    print(leg, json.dumps(rec), flush=True)


def _run_path(work, leg, seed):
    return os.path.join(work, f"{leg.replace('/', '__')}__{seed}.json")


def _run_pool(todo, jobs, work):
    """Each (leg, seed) of ``todo`` in a process of its own, ``jobs`` at
    a time; a run whose result is in ``work`` already is not repeated."""
    os.makedirs(work, exist_ok=True)
    todo = [ls for ls in todo if not os.path.exists(_run_path(work, *ls))]
    running, failed = [], []
    env = dict(os.environ, PYTHONPATH=ROOT)
    while todo or running:
        while todo and len(running) < jobs:
            leg, seed = todo.pop(0)
            out = _run_path(work, leg, seed)
            log = open(out + ".log", "w")
            p = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--leg", leg,
                 "--seed", str(seed), "--out", out],
                env=env, stdout=log, stderr=subprocess.STDOUT)
            running.append((p, leg, seed, log))
        time.sleep(1.0)
        for item in list(running):
            p, leg, seed, log = item
            if p.poll() is not None:
                running.remove(item)
                log.close()
                print(f"{leg} seed {seed}: exit {p.returncode}", flush=True)
                if p.returncode != 0:
                    failed.append((leg, seed))
    if failed:
        raise SystemExit(f"legs failed: {failed} (logs in {work})")


def _main_spread(legs, seeds, jobs, work):
    """The JAX legs over other seeds than the bound's (a leg's spread,
    to tell a port that diverges from a bound set by a few seeds); writes
    ``spread.json`` in ``work`` and leaves ``jax_reference.json`` alone."""
    _run_pool([(leg, s) for leg in legs for s in seeds], jobs, work)
    out = {}
    for leg in legs:
        runs = []
        for s in seeds:
            with open(_run_path(work, leg, s)) as fh:
                runs.append(json.load(fh))
        mean, sd = _summary(runs)
        out[leg] = {"seeds": list(seeds), "runs": runs, "mean": mean,
                    "sd": sd}
        print(leg, json.dumps({"mean": mean, "sd": sd}), flush=True)
    with open(os.path.join(work, "spread.json"), "w") as fh:
        json.dump(out, fh, indent=1)


def _main(jobs, work):
    jax = _force_cpu()
    t0 = time.time()
    for set_name, scens in (("eval", EVAL_SCENARIOS),
                            ("production", PRODUCTION_PROTOCOLS)):
        for s in scens:
            if not os.path.exists(fixture_path(set_name, s)):
                print("wrote", write_fixture(set_name, s), flush=True)

    todo = [(leg, seed) for leg in leg_names() for seed in leg_seeds(leg)]
    # seed by seed, the longest first within a seed: the pool does not
    # end on a long run, and the ~9 GB two_obj pf-xla runs are spread out
    todo.sort(key=lambda ls: (ls[1], ls[0] != "eval/two_obj/pf-xla",
                              not ls[0].startswith("production/"),
                              "pf-xla" not in ls[0]))
    _run_pool(todo, jobs, work)

    results = {}
    for leg in leg_names():
        results[leg] = []
        for seed in leg_seeds(leg):
            with open(_run_path(work, leg, seed)) as fh:
                results[leg].append(json.load(fh))
    doc = {
        "generated_by": "tests/torch_eval_reference.py",
        "jax_commit": _git_commit(),
        "jax_version": jax.__version__,
        "platform": "cpu",
        "written": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "bound_rule": bound_rule(),
        "sets": {
            "eval": {"frames": EVAL_FRAMES, "height": 30, "width": 40,
                     "render_seed": EVAL_RENDER_SEED,
                     "scenarios": list(EVAL_SCENARIOS),
                     "source": "benchmarks/eval_suite.py:46-135"},
            "production": {"frames": PRODUCTION_FRAMES, "height": 60,
                           "width": 80,
                           "render_seed": PRODUCTION_RENDER_SEED,
                           "scenarios": list(PRODUCTION_PROTOCOLS),
                           "source": "benchmarks/tpu_session26.py:73-125; "
                                     "Gaussian legs tpu_session30.py:59-64"},
        },
        "legs": aggregate(results),
    }
    with open(REFERENCE, "w") as fh:
        json.dump(doc, fh, indent=1)
    print("wrote", REFERENCE, f"in {time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    import argparse

    sys.path.insert(0, ROOT)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=5,
                    help="JAX runs in parallel (one process each)")
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "torch_eval_legs"),
                    help="directory for the per-run results; a run "
                         "whose result is there is not repeated")
    ap.add_argument("--spread", type=lambda t: t.split(","),
                    help="only run these legs (set/scenario/estimator,...) "
                         "over --seeds into --work/spread.json")
    ap.add_argument("--seeds", default="1-13",
                    help="tracker seeds A-B of --spread")
    ap.add_argument("--lockstep",
                    help="a PF leg: the JAX and the port's step on its "
                         "frames, the port fed JAX's draws (--seed, "
                         "--frames)")
    ap.add_argument("--first-weights",
                    help="a PF leg: frame 0's logliks and resampling "
                         "parents in both packages (--seed)")
    ap.add_argument("--frames", type=int, default=45)
    ap.add_argument("--leg", help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.leg:
        _main_leg(args.leg, args.seed, args.out)
    elif args.lockstep:
        _force_cpu()
        _main_lockstep(args.lockstep, args.seed or 1, args.frames)
    elif args.first_weights:
        _force_cpu()
        _main_first_weights(args.first_weights, args.seed or 1)
    elif args.spread:
        a, _, b = args.seeds.partition("-")
        _force_cpu()
        _main_spread(args.spread, range(int(a), int(b or a) + 1), args.jobs,
                     args.work)
    else:
        _main(args.jobs, args.work)
