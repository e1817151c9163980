"""Command-line tracker nodes: the executable surface of the port.

Port of ``dbot_ros_tpu/runtime/cli.py``:

  * ``track``: run a tracker from a config file over a recorded depth
    sequence, streaming ObjectState records to JSONL and reporting RMSE
    when the recording carries ground truth. ``--auto-init`` finds the
    first pose by the 6-DoF search, ``--watchdog`` re-acquires after a
    loss, ``--checkpoint`` saves the belief, ``--service SOCKET`` takes
    control commands on a Unix socket (``runtime/service.py``).
  * ``simulate``: closed-loop synthetic evaluation: render a scripted
    ground-truth trajectory through the production raycaster, track it,
    report RMSE.
  * ``record``: render a synthetic sequence to a replay .npz (generates
    fixtures for ``track``).

Every command runs on ``--device`` (default ``cuda``; without a CUDA
device the default fails, it never falls back to the CPU)::

    python -m dbot_ros_tpu_torch record   --config cfg.yaml --frames 60 \
        --output seq.npz
    python -m dbot_ros_tpu_torch track    --config cfg.yaml --input seq.npz \
        --auto-init --watchdog --output states.jsonl
    python -m dbot_ros_tpu_torch simulate --config cfg.yaml --frames 60

The config's ``tracker`` key picks the estimator (``particle`` or
``gaussian``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from dbot_ros_tpu_torch import config as cfg

_INIT_BUDGET_USAGE = ("--init-budget needs AXES,SPINS,PARTICLES,STEPS "
                      "(four integers >= 1)")


def _build_tracker(args):
    from dbot_ros_tpu_torch.trackers.base import describe

    conf = cfg.load_config(args.config)
    if isinstance(conf, cfg.ParticleTrackerConfig):
        from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
        tracker = ParticleTracker(conf, device=args.device)
    else:
        from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker
        tracker = GaussianTracker(conf, device=args.device)
    print(describe(tracker), file=sys.stderr)
    return tracker, conf


def _trajectory_fn(kind: str, start_pose, num_objects: int):
    """Scripted ground-truth trajectories for simulate/record:
    ``fn(t) → (K, 7)`` float32 tensor on the CPU."""
    from dbot_ros_tpu_torch.utils import se3

    start = torch.as_tensor(start_pose, dtype=torch.float32).cpu()
    if start.ndim == 1:
        start = start.expand(num_objects, 7)

    def shifted(dx):
        p = start.clone()
        p[:, 0] += dx
        return p

    def drift(t):
        return shifted(0.002 * t)

    def circle(t):
        ang = 0.04 * t
        dq = se3.so3_exp_quat(torch.tensor([0.0, ang, 0.0]))
        p = shifted(0.03 * float(np.sin(ang)))
        p[:, 3:7] = se3.quat_multiply(dq.expand(num_objects, 4), p[:, 3:7])
        return p

    def teleport(t):
        # induced tracking loss: the object jumps at frame 12, the
        # watchdog-recovery stress case
        return shifted(0.001 * t if t < 12 else -0.12)

    return {"drift": drift, "circle": circle, "teleport": teleport}[kind]


def _summarize(run, label: str):
    out = {
        "frames": int(run.poses.shape[0]),
        "mean_latency_ms": 1e3 * run.metrics.steady_state_latency(),
    }
    if run.ground_truth is not None:
        out["position_rmse_m"] = run.position_rmse()
        out["rotation_rmse_rad"] = run.rotation_rmse()
    if run.reinit_frames:
        out["watchdog_reinits"] = run.reinit_frames
        out["watchdog_reinit_seconds"] = run.reinit_seconds
    print(f"{label}: {json.dumps(out)}")
    return out


def _make_overlay(args, tracker):
    every = getattr(args, "overlay_every", 0) or 0
    if every <= 0:
        return None
    from dbot_ros_tpu_torch.runtime.overlay import make_overlay_hook
    out = getattr(args, "overlay_dir", None) or "overlays"
    return make_overlay_hook(tracker.meshes, tracker.camera, out,
                             every=every)


def _chain_hooks(*hooks):
    hooks = [h for h in hooks if h is not None]
    if not hooks:
        return None
    if len(hooks) == 1:
        return hooks[0]

    def chained(frame, poses, info):
        for h in hooks:
            h(frame, poses, info)

    return chained


def _parse_init_budget(args):
    """``--init-budget AXES,SPINS,PARTICLES,STEPS`` → search kwargs.
    Anything but four integers >= 1 exits with the usage message."""
    spec = getattr(args, "init_budget", None)
    if not spec:
        return {}
    parts = spec.split(",")
    if len(parts) != 4:
        raise SystemExit(_INIT_BUDGET_USAGE)
    try:
        ax, sp, rp, rs = (int(x) for x in parts)
    except ValueError:
        raise SystemExit(_INIT_BUDGET_USAGE) from None
    if min(ax, sp, rp, rs) < 1:
        raise SystemExit(_INIT_BUDGET_USAGE)
    return dict(n_axes=ax, n_spins=sp, refine_particles=rp,
                refine_steps=rs)


def _make_watchdog(args):
    if not getattr(args, "watchdog", False):
        return None
    from dbot_ros_tpu_torch.runtime.watchdog import TrackingWatchdog
    return TrackingWatchdog()


def cmd_track(args):
    from dbot_ros_tpu_torch.runtime import node
    from dbot_ros_tpu_torch.runtime.publisher import ObjectStatePublisher
    from dbot_ros_tpu_torch.runtime.sources import ReplaySource

    tracker, conf = _build_tracker(args)
    source = ReplaySource(args.input)

    initial = None
    if args.initial_pose:
        initial = np.asarray([float(x) for x in args.initial_pose.split()],
                             np.float32)
        if initial.size % 7:
            raise SystemExit("--initial-pose needs K*7 floats (t, quat wxyz)")
        initial = initial.reshape(-1, 7)
    init_kw = _parse_init_budget(args)
    if args.auto_init and not args.initial_pose:
        from dbot_ros_tpu_torch.runtime.initializer import initialize_tracker
        first = next(iter(source))
        t0 = time.perf_counter()
        pose0, score0 = initialize_tracker(tracker, first.depth, **init_kw)
        print("auto-init: " + json.dumps({
            "pose": [[float(v) for v in row]
                     for row in pose0.reshape(-1, 7).tolist()],
            "score": float(score0),
            "seconds": time.perf_counter() - t0}))

    mesh_names = conf.object.meshes or [
        f"object_{k}" for k in range(len(tracker.meshes))]
    publisher = ObjectStatePublisher(
        names=[str(m) for m in mesh_names],
        meshes=conf.object.mesh_paths() or None,
        path=args.output)
    service = None
    if getattr(args, "service", None):
        from dbot_ros_tpu_torch.runtime.service import TrackerService
        service = TrackerService(args.service)
    try:
        # With --auto-init the tracker is already initialized above and
        # node.run skips initialization when initial_pose is None.
        run = node.run(tracker, source, initial_pose=initial,
                       on_frame=_chain_hooks(publisher,
                                             _make_overlay(args, tracker)),
                       checkpoint_path=args.checkpoint,
                       checkpoint_every=args.checkpoint_every,
                       watchdog=_make_watchdog(args),
                       reinit_kwargs=init_kw or None,
                       service=service)
    finally:
        publisher.close()
        if service is not None:
            service.close()
    _summarize(run, "track")
    if getattr(args, "metrics", None):
        run.metrics.to_jsonl(args.metrics)
    return 0


def _synthetic_source(args, tracker):
    from dbot_ros_tpu_torch.runtime.sources import SyntheticSource

    start = torch.tensor([0.0, 0.0, args.distance, 1.0, 0.0, 0.0, 0.0])
    traj = _trajectory_fn(args.trajectory, start, len(tracker.meshes))
    return SyntheticSource(tracker.meshes, tracker.camera,
                           lambda t: traj(t).numpy(),
                           num_frames=args.frames,
                           noise_sigma=args.noise_sigma,
                           dropout_prob=args.dropout, seed=args.seed)


def cmd_simulate(args):
    from dbot_ros_tpu_torch.runtime import node

    tracker, conf = _build_tracker(args)
    run = node.run(tracker, _synthetic_source(args, tracker),
                   watchdog=_make_watchdog(args),
                   on_frame=_make_overlay(args, tracker))
    out = _summarize(run, "simulate")
    if args.max_rmse is not None and out["position_rmse_m"] > args.max_rmse:
        print(f"FAIL: position RMSE {out['position_rmse_m']:.4f} > "
              f"{args.max_rmse}", file=sys.stderr)
        return 1
    return 0


def cmd_record(args):
    from dbot_ros_tpu_torch.runtime.sources import record_npz

    tracker, conf = _build_tracker(args)
    depth, poses = [], []
    for frame in _synthetic_source(args, tracker):
        depth.append(frame.depth.reshape(tracker.camera.height,
                                         tracker.camera.width))
        poses.append(frame.ground_truth)
    record_npz(args.output, np.stack(depth), np.stack(poses))
    print(f"record: wrote {len(depth)} frames to {args.output}")
    return 0


def _add_common_args(p):
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device the tracker runs on (default: cuda; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("--overlay-every", type=int, default=0, metavar="N",
                   help="write a silhouette-overlay PNG every N frames")
    p.add_argument("--overlay-dir", default="overlays")


def _add_sim_args(p):
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--trajectory",
                   choices=("drift", "circle", "teleport"),
                   default="drift")
    p.add_argument("--distance", type=float, default=0.8,
                   help="initial camera-frame z of the object(s)")
    p.add_argument("--noise-sigma", type=float, default=0.003)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="dbot_ros_tpu_torch",
        description="Depth-based object tracking on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    p_track = sub.add_parser("track", help="track a recorded sequence")
    _add_common_args(p_track)
    p_track.add_argument("--input", required=True,
                         help="replay .npz/.npy depth stack")
    p_track.add_argument("--output", default=None,
                         help="JSONL ObjectState stream")
    p_track.add_argument("--metrics", default=None,
                         help="JSONL per-frame metrics (latency, ESS, "
                              "trial_hypotheses, ...)")
    p_track.add_argument("--initial-pose", default=None,
                         help="K*7 floats 'x y z qw qx qy qz ...'")
    p_track.add_argument("--auto-init", action="store_true",
                         help="search the first frame for the initial pose")
    p_track.add_argument("--watchdog", action="store_true",
                         help="tracking-loss auto-recovery (re-init via "
                              "the 6-DoF search when divergence trips)")
    p_track.add_argument("--init-budget", default=None,
                         metavar="AXES,SPINS,PARTICLES,STEPS",
                         help="6-DoF search budget for --auto-init and "
                              "watchdog re-inits (default 12,4,256,4; "
                              "lower = faster init/recovery, coarser "
                              "basin coverage)")
    p_track.add_argument("--checkpoint", default=None)
    p_track.add_argument("--checkpoint-every", type=int, default=0)
    p_track.add_argument("--service", default=None, metavar="SOCKET",
                         help="serve the newline-JSON control protocol "
                              "(status, pause, resume, reset_pose, "
                              "find_object, checkpoint, shutdown) on this "
                              "Unix socket")
    p_track.set_defaults(fn=cmd_track)

    p_sim = sub.add_parser("simulate",
                           help="closed-loop synthetic evaluation")
    _add_common_args(p_sim)
    _add_sim_args(p_sim)
    p_sim.add_argument("--watchdog", action="store_true",
                       help="tracking-loss auto-recovery")
    p_sim.add_argument("--max-rmse", type=float, default=None,
                       help="exit 1 if position RMSE exceeds this")
    p_sim.set_defaults(fn=cmd_simulate)

    p_rec = sub.add_parser("record", help="render a replay .npz fixture")
    _add_common_args(p_rec)
    p_rec.add_argument("--output", required=True)
    _add_sim_args(p_rec)
    p_rec.set_defaults(fn=cmd_record)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
