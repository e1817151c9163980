"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

The program under test is ``dbot_ros_tpu_torch``: its tracker (built from
the configuration through its public API, as ``track --config`` builds
it), its streaming loop ``runtime.node.run`` and, in an open-loop cell,
its camera path (``native.preprocess_depth_u16`` and
``runtime.sources.ThreadedSource``). The benchmark makes the frames,
keeps its own clock around the calls into each layer, reads the
program's counters, and checks the poses the window published against
the plain reference in ``portbench/reference``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import os
import sys
import tempfile
import threading
import time
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, record_function

from portbench.core import checks as checks_mod
from portbench.core import report, spec
from portbench.core import trace as trace_mod
from portbench.core import traffic as traffic_mod
from portbench.reference import pf, scene

FORBIDDEN = ("jax", "jaxlib", "flax", "dbot_ros_tpu")
CHECKS = 8              # frames of the window the check samples
DEVICE_TRACE_S = 1.0    # traced run: the device trace, no host op recorded
HOST_TRACE_S = 0.5      # then the host's ops, to the window's close
HOST_MARK = "portbench.host_trace"


@dataclasses.dataclass
class FrameRec:
    """One frame of the window, times in seconds (``time.perf_counter``)."""

    index: int                 # the loop's frame index
    hand: float                # handed to the loop (closed) / popped (open)
    due: Optional[float] = None     # its due time on the camera's schedule
    track0: Optional[float] = None  # ``track`` called
    track1: Optional[float] = None  # ``track`` returned
    done: Optional[float] = None    # the pose on the host (``on_frame``)
    pose: Optional[np.ndarray] = None  # the published poses (K, 7)
    level: Optional[int] = None     # the PF sensor's ladder level
    resampled: Optional[bool] = None
    skipped: Optional[int] = None
    counts: Optional[tuple] = None  # (n_active, n_uniq), the reference's
    phase: Optional[str] = None     # traced run: "device" | "host"
    depth: Optional[np.ndarray] = None  # the frame the loop got (open loop)


@dataclasses.dataclass
class Run:
    """What the readers read: the cell, the window's frames, the traced
    stretch, the program's objects and the scene's sizes."""

    cell: str
    kind: str                  # "particle" | "gaussian"
    settings: dict
    traffic: traffic_mod.Traffic
    seconds: float
    frames: List[FrameRec]
    t_start: float
    t_end: float
    offered: int = 0           # frames the camera offered (open loop)
    dropped: int = 0           # frames the ring dropped (open loop)
    trace: Optional[trace_mod.Trace] = None       # the device trace
    host_trace: Optional[trace_mod.Trace] = None  # the host ops' stretch
    num_pixels: int = 0
    num_particles: int = 0
    objects: int = 1           # K, the tracked objects (coordinate blocks)
    camera_lateness_s: float = 0.0
    untraced_fps: Optional[float] = None  # frames a second before the trace

    @property
    def window_frames(self):
        return [f for f in self.frames if f.done is not None]

    def untraced(self):
        return [f for f in self.window_frames if f.phase is None]

    def traced_frames(self):
        """The frames of the device trace."""
        return [f for f in self.window_frames if f.phase == "device"]


class TimedTracker:
    """A pass-through proxy of the tracker handed to ``node.run``: the
    benchmark's clock around ``track``, and a count of the steps since
    the last ``initialize`` (the reference replays the tracker's random
    stream by it)."""

    _own = ("inner", "calls", "current", "on_track", "initialize")

    def __init__(self, inner):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "calls", 0)
        object.__setattr__(self, "current", None)
        object.__setattr__(self, "on_track", None)

        # the loop reads the signature (``first_frame``): keep the inner's
        @functools.wraps(inner.initialize)
        def initialize(*args, **kwargs):
            object.__setattr__(self, "calls", 0)
            return inner.initialize(*args, **kwargs)

        object.__setattr__(self, "initialize", initialize)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        if name in TimedTracker._own:
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)

    def track(self, depth_image, dt=None):
        rec = self.current
        t0 = time.perf_counter()
        out = (self.inner.track(depth_image) if dt is None
               else self.inner.track(depth_image, dt=dt))
        t1 = time.perf_counter()
        object.__setattr__(self, "calls", self.calls + 1)
        if rec is not None:
            rec.track0, rec.track1 = t0, t1
        if self.on_track is not None:
            self.on_track(rec, out)
        return out


def build_tracker(kind: str, settings: dict, device):
    from dbot_ros_tpu_torch import config as cfg
    if kind == "particle":
        from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
        return ParticleTracker(cfg.particle_config_from_dict(settings),
                               device=device)
    from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker
    return GaussianTracker(cfg.gaussian_config_from_dict(settings),
                           device=device)


def forbidden_modules():
    """Modules of JAX or the JAX package loaded in this process, compared
    by their whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _snapshot(tracker, kind):
    """A copy of the belief the tracker holds (the particle tracker's is
    donated: its next step overwrites it)."""
    b = tracker.belief
    if kind == "particle":
        occ = b.occlusion
        occ = (tuple(x.clone() for x in occ)
               if isinstance(occ, (tuple, list)) else occ.clone())
        return (b.states.clone(), b.log_weights.clone(), occ)
    return b          # the Gaussian tracker's belief is a fresh copy


class _Checks:
    """The frames the check samples and what it keeps of them: the
    belief before the frame, the published pose, the step's info and the
    belief carried into the next frame.

    Each copy of the belief is taken once the pose of the frame before is
    on the host (``after``), so no frame's timed interval holds one; a
    copy serves as the carry of the frame just posed and as the belief
    before the next. The copies' bytes are kept out of the memory peak,
    which is the program's (``program_peak``)."""

    def __init__(self, times, kind, device):
        self.times = sorted(times)
        self.kind = kind
        self.device = torch.device(device)
        self.taken = []          # dicts, one per sampled frame
        self._held = None        # (copy, calls) for the next frame
        self._open = None        # the sampled frame whose carry is due
        self._bytes = 0          # held by the copies
        self._peak = 0

    def _copy(self, tracker):
        _sync(self.device)
        cuda = self.device.type == "cuda"
        if cuda:
            self._peak = max(self._peak, torch.cuda.max_memory_allocated()
                             - self._bytes)
            before = torch.cuda.memory_allocated()
        snap = _snapshot(tracker, self.kind)
        _sync(self.device)
        if cuda:
            self._bytes += torch.cuda.memory_allocated() - before
            torch.cuda.reset_peak_memory_stats()
        return snap

    def after(self, tracker, rec: FrameRec, t_rel: float):
        """Frame ``rec``'s pose is on the host, ``t_rel`` s into the
        window: keeps its carry if it is sampled, and the belief before
        the next frame if a sample time has passed."""
        due = bool(self.times) and t_rel >= self.times[0]
        while self.times and t_rel >= self.times[0]:
            self.times.pop(0)
        open_ = self._open is not None and self._open["rec"] is rec
        if not (due or open_):
            return
        snap = self._copy(tracker)
        if open_:
            self._open["carry"] = snap
            self._open = None
        self._held = (snap, tracker.calls) if due else None

    def hand(self, rec: FrameRec, dt):
        """Frame ``rec`` is handed to the loop over the interval ``dt``."""
        if self._held is None:
            return
        (snap, calls), self._held = self._held, None
        entry = {"rec": rec, "before": snap, "call": calls, "dt": dt}
        self.taken.append(entry)
        self._open = entry

    def on_track(self, rec, out):
        if self._open is not None and self._open["rec"] is rec:
            self._open["info"] = out[1]

    def program_peak(self) -> int:
        """The device memory peak with the copies' bytes taken out."""
        if self.device.type != "cuda":
            return 0
        return int(max(self._peak, torch.cuda.max_memory_allocated()
                       - self._bytes))


class _Tracer:
    """The traced stretch at the window's close: one profiler, first with
    the recording of host ops switched off (the device trace: busy time,
    device operations, copies, the kernels' times), then with it on for
    the last ``HOST_TRACE_S`` (the host's ops a frame and what the host
    did in the device's idle gaps). Each frame handed in it is marked
    with its phase."""

    def __init__(self, device, t_stop, seconds):
        self.device = device
        self.at = {"device": t_stop - min(DEVICE_TRACE_S + HOST_TRACE_S,
                                          0.5 * seconds),
                   "host": t_stop - min(HOST_TRACE_S, seconds / 6.0)}
        self.prof = None
        self.phase = None
        self.t = {}

    def tick(self, now) -> Optional[str]:
        """Before a frame is handed over at ``now``: its phase."""
        if self.phase is None and now >= self.at["device"]:
            self.prof = _start_profiler(self.device)
            self.prof.toggle_collection_dynamic(False,
                                                [ProfilerActivity.CPU])
            self.phase = "device"
            self.t["device"] = time.perf_counter()
        if self.phase == "device" and now >= self.at["host"]:
            self.prof.toggle_collection_dynamic(True,
                                                [ProfilerActivity.CPU])
            with record_function(HOST_MARK):
                pass
            self.phase = "host"
            self.t["host"] = time.perf_counter()
        return self.phase

    def close(self, frames, t_end):
        """After the window: (device trace, host trace, frames a second
        untraced / in each phase)."""
        if self.prof is None:
            return None, None, {}
        self.prof.__exit__(None, None, None)
        events = trace_mod.events(self.prof)
        self.prof = None
        t_host = self.t.get("host", t_end)
        n = {p: sum(1 for f in frames if f.phase == p and f.done)
             for p in ("device", "host")}
        dev, host = trace_mod.split(events, HOST_MARK,
                                    t_host - self.t["device"],
                                    t_end - t_host, n["device"], n["host"])
        rates = {"device": n["device"] / max(t_host - self.t["device"],
                                             1e-9)}
        if "host" in self.t:
            rates["host"] = n["host"] / max(t_end - t_host, 1e-9)
        return dev, host, rates


def run_cell(cell: str, seed: int, seconds: float, traced: bool,
             device="cuda", t_process: Optional[float] = None,
             overrides: Optional[dict] = None, tracker_factory=None,
             log=None) -> dict:
    """One run of ``cell``; returns the result line's dict (with the
    checks' numbers under ``checks``). ``overrides`` (tests) merges into
    the configuration's settings and the mix's parameters;
    ``tracker_factory(kind, settings, device)`` replaces the program's
    tracker (the tests' planted faults and the control)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_process = time.perf_counter() if t_process is None else t_process
    w = spec.workload(cell)
    conf = spec.config(w["config"])
    params = spec.traffic(w["traffic"])
    kind = conf["tracker"]
    settings = copy.deepcopy(conf["settings"])
    if overrides:
        _merge(settings, overrides.get("settings", {}))
        _merge(params, overrides.get("traffic", {}))
        _merge(conf, {k: v for k, v in overrides.items()
                      if k in ("assumed", "limits")})
    spec.objects(conf, params)
    settings["seed"] = int(traffic_mod.sub_seed(seed, "tracker")
                           .generate_state(1)[0])
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()

    # -- set-up: the scene, the frames, the tracker, the warm-up ---------
    obj_texts = [scene.object_obj_text(m) for m in spec.meshes(conf)]
    tmp = tempfile.mkdtemp(prefix="portbench-")
    settings["object"]["meshes"] = []
    for k, text in enumerate(obj_texts):
        path = os.path.join(tmp, f"object{k}.obj")
        with open(path, "w") as fh:
            fh.write(text)
        settings["object"]["meshes"].append(path)
    stages = {"imports": time.perf_counter()}
    traffic = traffic_mod.make(params, settings, obj_texts, seed, device)
    if device.type == "cuda":
        # the renderer's peak is the harness's, not the program's
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    stages["frames"] = time.perf_counter()
    factory = tracker_factory or build_tracker
    tracker = TimedTracker(factory(kind, settings, device))
    from dbot_ros_tpu_torch.runtime import node

    convert = None
    if traffic.native:
        from dbot_ros_tpu_torch.native import preprocess_depth_u16
        convert = preprocess_depth_u16
    dt_nominal = 1.0 / float(settings["camera"]["frame_rate"])

    start = {}
    warm = traffic.warmup_frames
    sensor = getattr(tracker.inner, "sensor", None)

    def warm_source():
        for i in range(warm):
            yield _Frame(i, traffic_mod.tracker_frame(traffic, i, convert))

    def warm_frame(frame, poses, info):
        if frame.index == 0:
            start["pose"] = np.array(poses, np.float64)
            start["info"] = info
            if traffic.objects > 1:
                # the particles carried out of the step give the check
                # the resampling parents of its blocks before the last
                start["carried"] = tracker.belief.states.clone()

    stages["tracker"] = time.perf_counter()
    node.run(tracker, warm_source(), initial_pose=traffic.poses(0),
             on_frame=warm_frame)
    stages["warm-up"] = time.perf_counter()
    if traced:
        _warm_profiler(device)
    gc.collect()
    _sync(device)

    # -- the measured window ------------------------------------------------
    rng = np.random.default_rng(traffic_mod.sub_seed(seed, "check"))
    # sampled outside the traced stretch, so that no copy lands in it
    check = _Checks(rng.uniform(0.0, max(seconds - DEVICE_TRACE_S
                                         - HOST_TRACE_S, 0.5 * seconds),
                                CHECKS), kind, device)
    tracker.on_track = check.on_track
    frames: List[FrameRec] = []
    by_index = {}
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    unix_start = time.time()
    marks = [("", t_process)] + list(stages.items()) + [("rest", t_start)]
    log("set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks,
                                                          marks[1:])))
    t_stop = t_start + seconds
    tracer = _Tracer(device, t_stop, seconds) if traced else None

    def phase(now):
        return tracer.tick(now) if tracer is not None else None

    def on_frame(frame, poses, info):
        rec = by_index.get(frame.index)
        if rec is None:
            return
        rec.done = time.perf_counter()
        rec.pose = np.array(poses, np.float64)
        rec.level = getattr(sensor, "last_level", None)
        check.after(tracker, rec, rec.done - t_start)

    offered = []
    source = None
    camera = None
    if traffic.loop == "closed":
        def closed_source():
            i = warm
            while True:
                now = time.perf_counter()
                if now >= t_stop:
                    return
                rec = FrameRec(index=i, hand=0.0, phase=phase(now))
                depth = traffic_mod.tracker_frame(traffic, i, convert)
                check.hand(rec, dt_nominal)
                rec.hand = time.perf_counter()
                tracker.current = rec
                frames.append(rec)
                by_index[i] = rec
                yield _Frame(i, depth)
                i += 1

        loop_source = closed_source()
    else:
        from dbot_ros_tpu_torch.runtime.sources import ThreadedSource
        source = ThreadedSource(frame_shape=traffic_mod.tracker_frame(
            traffic, 0, convert).shape, capacity=int(params.get(
                "ring_capacity", 8)))
        period = 1.0 / traffic.rate_hz
        lateness = [0.0]

        def camera_thread():
            try:
                k = 0
                while True:
                    due = t_start + k * period
                    if due >= t_stop:
                        break
                    delay = due - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    lateness[0] = max(lateness[0], time.perf_counter() - due)
                    depth = convert(traffic.frames[(warm + k)
                                                   % traffic.period],
                                    traffic.downsampling)
                    offered.append((k, due))
                    source.push(depth, index=k)
                    k += 1
            finally:
                source.close()

        camera = threading.Thread(target=camera_thread, daemon=True,
                                  name="portbench-camera")
        camera.start()

        def open_source():
            for fr in source:
                now = time.perf_counter()
                rec = FrameRec(index=fr.index, hand=now,
                               due=t_start + fr.index * period,
                               skipped=fr.skipped, depth=fr.depth,
                               phase=phase(now))
                check.hand(rec, dt_nominal * (1 + (fr.skipped or 0)))
                tracker.current = rec
                frames.append(rec)
                by_index[fr.index] = rec
                yield fr

        loop_source = open_source()

    track_run = node.run(tracker, loop_source, on_frame=on_frame)
    _sync(device)
    t_end = time.perf_counter()
    unix_end = time.time()
    if camera is not None:
        camera.join(timeout=60.0)
        if camera.is_alive():
            raise RuntimeError("the camera thread did not stop")
    tracker.current = None

    run = Run(cell=cell, kind=kind, settings=settings, traffic=traffic,
              seconds=seconds, frames=frames, t_start=t_start, t_end=t_end,
              num_particles=int(settings.get("evaluation_count", 0)),
              objects=traffic.objects)
    run.num_pixels = int(traffic_mod.tracker_frame(traffic, 0).size)
    for m in track_run.metrics.records:
        rec = by_index.get(m.frame)
        if rec is not None:
            rec.resampled = m.resampled
    if traffic.loop != "closed":
        run.offered = len(offered)
        run.dropped = int(source.skipped_total)
        run.camera_lateness_s = lateness[0]
    rates = {}
    if tracer is not None:
        run.trace, run.host_trace, rates = tracer.close(frames, t_end)
        rest = run.untraced()
        if rest and tracer.t:
            run.untraced_fps = len(rest) / (tracer.t["device"] - t_start)
            rates["untraced"] = run.untraced_fps

    # -- the memory peak, then the program's state is freed -------------
    peak = check.program_peak()
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    inner = tracker.inner
    del tracker, track_run, source, sensor
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check against the reference, and the frames' work counts ---
    verdict = checks_mod.check(kind, settings, obj_texts, conf, traffic,
                               start, check.taken, device)
    del inner, check
    if kind == "particle" and run.trace is not None:
        _count_work(run, settings, obj_texts, device)
    result = report.result(run, spec, traced, setup_s, peak, device,
                           verdict)
    result["info"]["window_unix"] = [unix_start, unix_end]
    result["info"]["traced_frames_per_s"] = rates
    _cleanup(tmp)
    return result


def _count_work(run: Run, settings, obj_texts, device):
    """The candidate table's counts of every frame of the device trace,
    from the reference's own candidate pass at the frame's true poses
    (every object's triangles in one table): what the fused likelihood's
    work count (``portbench/roofline/fused_loglik.py``) reads."""
    ref = pf.ParticleReference(settings, obj_texts, device)
    traffic = run.traffic
    counts = {}
    for f in run.traced_frames():
        i = (f.index if traffic.loop == "closed"
             else traffic.warmup_frames + f.index) % traffic.period
        if i not in counts:
            counts[i] = ref.candidate_counts(traffic.poses(i))
        f.counts = counts[i]


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded in this process: " + ", ".join(names))
        self.names = names


@dataclasses.dataclass
class _Frame:
    index: int
    depth: np.ndarray
    ground_truth: Optional[np.ndarray] = None
    skipped: Optional[int] = None


def _merge(base: dict, extra: dict):
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v


def _warm_profiler(device):
    """Run the profiler once in set-up as the traced stretch runs it, so
    that its first start (CUPTI's initialisation) falls outside the
    window."""
    prof = _start_profiler(device)
    prof.toggle_collection_dynamic(False, [ProfilerActivity.CPU])
    x = torch.zeros(16, device=device)
    x.add_(1.0)
    prof.toggle_collection_dynamic(True, [ProfilerActivity.CPU])
    x.add_(1.0)
    _sync(device)
    prof.__exit__(None, None, None)


def _start_profiler(device):
    from torch.profiler import profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _cleanup(tmp):
    try:
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    except OSError:
        pass


