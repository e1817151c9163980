"""The spans of the loop, the trackers and the step program
(``utils/profiling.py``) and the launch counters a replay carries
(``utils/graphs.py`` ``COUNTERS``).

A span is recorded only while a profiler runs; under
``torch.profiler.profile`` (the CPU here) each frame of ``node.run``
gives one span of each kind, nested in its parent by its start and end. Scene: a 40×30 camera (fx 60), a 320-face icosphere 0.6 m
away over a background at 2 m, frames rendered before the loop starts
(so that the source's own render adds no span).
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch.ops import kernels
from dbot_ros_tpu_torch.runtime import node, sources
from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
from dbot_ros_tpu_torch.utils import camera, graphs, mesh, profiling

torch.set_num_threads(1)

K40 = np.array([[60.0, 0, 20], [0, 60.0, 15], [0, 0, 1.0]])
P0 = np.array([0.0, 0.0, 0.6, 1, 0, 0, 0], np.float32)
EMPTY = np.full((30, 40), 2.0, np.float32)
FRAMES = 4


def scene(num_frames=FRAMES):
    sphere = mesh.icosphere_mesh(radius=0.06, subdivisions=2)
    cam = camera.make_camera(K40, 30, 40)

    def path(t):
        p = P0.copy()
        p[0] += 0.002 * t
        return p[None]

    frames = list(sources.SyntheticSource([sphere], cam, path, num_frames,
                                          noise_sigma=0.002, seed=3))
    return sphere, cam, frames


def particle_tracker(sphere, cam):
    tracker = ParticleTracker(cfg.ParticleTrackerConfig(
        evaluation_count=256, backend="pallas"), meshes=[sphere],
        camera=cam, device="cpu")
    tracker.initialize(P0)
    return tracker


def gaussian_tracker(sphere, cam):
    tracker = GaussianTracker(cfg.GaussianTrackerConfig(), meshes=[sphere],
                              camera=cam, device="cpu")
    tracker.initialize(P0, first_frame=EMPTY)
    return tracker


def recorded(tracker, frames, on_frame=None):
    """``node.run`` under the CPU profiler → its events as (name, start
    ns, end ns), host only, in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        node.run(tracker, frames, on_frame=on_frame)
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    return sorted(evs, key=lambda e: e[1])


def named(evs, name):
    return [e for e in evs if e[0] == name]


def inside(child, parents):
    """The one span of ``parents`` that holds ``child`` by start and end."""
    holding = [p for p in parents if p[1] <= child[1] and child[2] <= p[2]]
    assert len(holding) == 1, (child, holding)
    return holding[0]


def assert_one_per_frame(evs, tree):
    """Each span named in ``tree`` (child → parent) comes once a frame and
    lies inside a span of its parent's name."""
    frames = named(evs, "dbot.loop.frame")
    assert len(frames) == FRAMES
    for child, parent in tree.items():
        got = named(evs, child)
        assert len(got) == FRAMES, (child, len(got))
        holders = [inside(c, named(evs, parent)) for c in got]
        assert len(set(holders)) == FRAMES, child


def test_without_a_profiler_no_span_enters_record_function(monkeypatch):
    """(a) No profiler: ``span`` never builds a recorded span
    (``record_function`` or the op it records), over three frames of the
    loop and its tracker."""
    sphere, cam, frames = scene(3)
    tracker = particle_tracker(sphere, cam)

    def refuse(*a, **k):
        raise AssertionError("a span recorded without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Recorded", refuse)
    run = node.run(tracker, frames)
    assert run.poses.shape == (3, 1, 7)
    assert profiling.span("dbot.x") is profiling.span("dbot.y", "key")


def test_particle_loop_spans_once_a_frame_and_nest():
    """(b) The particle tracker with the fused sensor's ladder: one of each
    span a frame, each inside its parent."""
    sphere, cam, frames = scene()
    tracker = particle_tracker(sphere, cam)
    assert tracker.sensor.caps(cam.num_pixels)      # the ladder is there
    evs = recorded(tracker, frames)
    assert_one_per_frame(evs, {
        "dbot.track": "dbot.loop.frame",
        "dbot.read.pose": "dbot.loop.frame",
        "dbot.read.metrics": "dbot.loop.frame",
        "dbot.track.upload": "dbot.track",
        "dbot.step.noise": "dbot.track",
        "dbot.step.run:propose": "dbot.track",
        "dbot.read.ladder": "dbot.track",
        "dbot.step.run:level": "dbot.track",
        "dbot.step.copy_out": "dbot.track",
        "dbot.track.smooth": "dbot.track"})
    # the ladder's read comes between the two graphs of the block
    for p, r, lv in zip(named(evs, "dbot.step.run:propose"),
                        named(evs, "dbot.read.ladder"),
                        named(evs, "dbot.step.run:level")):
        assert p[2] <= r[1] and r[2] <= lv[1]
    # the source: before the first frame and after each
    assert len(named(evs, "dbot.loop.source")) == FRAMES + 1
    for name in ("dbot.loop.on_frame", "dbot.loop.watchdog",
                 "dbot.loop.service", "dbot.step.capture:propose"):
        assert not named(evs, name), name


@pytest.mark.parametrize("ladder", [True, False])
def test_the_sensor_marks_its_ladder_level(ladder):
    """The fused sensor marks the level it chose, ``FusedSensor.last_level``,
    with one empty span ``dbot.sensor.level:<level>`` a frame, after the
    ladder's read and inside the tracker's call; a sensor without a
    ladder (one level that compacts nothing) reads nothing and marks
    nothing."""
    sphere, cam, frames = scene()
    tracker = particle_tracker(sphere, cam)
    if not ladder:
        tracker = ParticleTracker(cfg.ParticleTrackerConfig(
            evaluation_count=256, backend="pallas",
            backend_options={"levels": [(1.0, 1.0)]}), meshes=[sphere],
            camera=cam, device="cpu")
        tracker.initialize(P0)
        assert not tracker.sensor.caps(cam.num_pixels)
    levels = []
    evs = recorded(tracker, frames, lambda *a: levels.append(
        tracker.sensor.last_level))
    marks = [e for e in evs if e[0].startswith("dbot.sensor.level")]
    if not ladder:
        assert levels == [0] * FRAMES
        assert not marks and not named(evs, "dbot.read.ladder")
        return
    assert [m[0] for m in marks] == [f"dbot.sensor.level:{lv}"
                                     for lv in levels]
    tracks = named(evs, "dbot.track")
    for mark, read in zip(marks, named(evs, "dbot.read.ladder")):
        assert read[2] <= mark[1]
        inside(mark, tracks)
        assert not [e for e in evs if e[0].startswith("aten::")
                    and mark[1] <= e[1] < mark[2]]


def test_gaussian_loop_spans_once_a_frame_and_nest():
    """(c) The Gaussian tracker: no ladder read, one ``step`` graph a
    frame."""
    sphere, cam, frames = scene()
    tracker = gaussian_tracker(sphere, cam)
    evs = recorded(tracker, frames)
    assert_one_per_frame(evs, {
        "dbot.track": "dbot.loop.frame",
        "dbot.read.pose": "dbot.loop.frame",
        "dbot.read.metrics": "dbot.loop.frame",
        "dbot.track.upload": "dbot.track",
        "dbot.step.run:step": "dbot.track",
        "dbot.step.copy_out": "dbot.track",
        "dbot.track.smooth": "dbot.track"})
    assert not named(evs, "dbot.read.ladder")
    assert not named(evs, "dbot.step.noise")
    assert not [e for e in evs if e[0].startswith("dbot.step.run:")
                and e[0] != "dbot.step.run:step"]


def test_the_callers_work_is_its_own_span():
    """(d) ``dbot.loop.on_frame`` holds the caller's callback, and the aten
    ops the callback runs lie outside ``dbot.track``."""
    sphere, cam, frames = scene()
    tracker = particle_tracker(sphere, cam)
    marks = []

    def on_frame(frame, poses, info):
        with torch.profiler.record_function("caller.work"):
            marks.append(torch.ones(64).cumsum(0).sum())

    evs = recorded(tracker, frames, on_frame)
    assert_one_per_frame(evs, {"dbot.loop.on_frame": "dbot.loop.frame",
                               "caller.work": "dbot.loop.on_frame"})
    tracks = named(evs, "dbot.track")
    for work in named(evs, "caller.work"):
        ops = [e for e in evs if e[0] == "aten::cumsum"
               and work[1] <= e[1] <= work[2]]
        assert ops
        for op in ops:
            assert not any(t[1] <= op[1] <= t[2] for t in tracks)


def test_every_kernel_wrapper_counts_over_replays():
    """(e) Every wrapper's ``launches``, the distributed exchanges' too,
    and the two-width count are carried over replays."""
    wrappers = {**kernels.WRAPPERS, **kernels.EXCHANGE_WRAPPERS}
    assert "age_pixel_rows" in wrappers
    counted = set(graphs.COUNTERS)
    for w in wrappers.values():
        assert (w, "launches") in counted, w.__name__
    assert (kernels.lineage_gather, "two_width_launches") in counted
    assert len(counted) == len(graphs.COUNTERS) == len(wrappers) + 1


def test_a_replayed_exchange_counts_its_row_aging(monkeypatch):
    """A captured ``("exchange", b, path)`` graph that ages the map's rows
    counts ``age_pixel_rows`` once a call, replays included (a stand-in
    graph on the CPU)."""
    from tests.test_torch_graphs import stand_in_cuda

    stand_in_cuda(monkeypatch)
    monkeypatch.setattr(kernels.age_pixel_rows, "launches", 0)
    prog = graphs.StepProgram("cpu")
    q = torch.rand(6, 8)

    def exchange():
        kernels.age_pixel_rows.launches += 1     # as a launch on the card
        return prog.keep("q", q * 0.5)

    for _ in range(4):
        prog.run(("exchange", 0, "moves"), exchange)
    assert prog._graphs[("exchange", 0, "moves")].graph.replays == 3
    assert kernels.age_pixel_rows.launches == 4


def test_a_span_without_a_profiler_is_cheap():
    """(f) 10^5 spans entered and left with no profiler take under 0.1 s."""
    span = profiling.span
    t0 = time.perf_counter()
    for _ in range(100_000):
        with span("dbot.step.run", "propose"):
            pass
    assert time.perf_counter() - t0 < 0.1


def test_a_span_under_a_profiler_is_recorded_with_its_key():
    """Under a profiler ``span(name, key)`` is one event ``name:key`` that
    holds the ops inside it; after the profiler stops, spans are off."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("dbot.step.run", "level"):
            torch.ones(4).add_(1.0)
        with profiling.span("dbot.read.pose"):
            pass
    evs = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()),
                 key=lambda e: e[1])
    (run,) = named(evs, "dbot.step.run:level")
    # an op, not a user annotation: nothing mirrored on a device timeline
    assert not any(e.is_user_annotation()
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("dbot."))
    assert len(named(evs, "dbot.read.pose")) == 1
    add = named(evs, "aten::add_")
    assert add and inside(add[0], [run]) == run
    assert profiling.span("dbot.read.pose") is profiling.span("dbot.track")


@pytest.mark.parametrize("kind", ["particle", "gaussian"])
def test_a_profiled_run_tracks_as_an_unprofiled_one(kind):
    """Spans change no result: the same frames give the same poses with
    and without a profiler running."""
    sphere, cam, frames = scene()
    make = particle_tracker if kind == "particle" else gaussian_tracker
    plain = node.run(make(sphere, cam), frames).poses
    with profile(activities=[ProfilerActivity.CPU]):
        traced = node.run(make(sphere, cam), frames).poses
    np.testing.assert_array_equal(plain, traced)
