"""The readers of the program's spans give known answers on a hand-built
host trace, and nothing on a trace without the program's spans."""

import pytest

from portbench.core import spans, spec, trace
from portbench.core.runner import Run

READERS = ("step.graph_launches_per_frame", "step.read_wait_ms_per_frame",
           "runtime.read_wait_ms_per_frame", "trackers.host_ops_per_frame",
           "runtime.host_ops_per_frame", "device.idle_unattributed_share")


def _frame(o):
    """One frame's host events, ``o`` seconds into the trace."""
    ev = [("dbot.loop.source", 0.00, 0.02),
          ("dbot.loop.frame", 0.02, 0.40),
          ("dbot.track", 0.03, 0.30),
          ("aten::empty", 0.04, 0.045), ("aten::copy_", 0.05, 0.055),
          ("dbot.step.run:propose", 0.10, 0.12),
          ("cudaGraphLaunch", 0.10, 0.119),
          ("dbot.read.ladder", 0.13, 0.16),
          ("cudaMemcpyAsync", 0.13, 0.159),
          ("dbot.step.run:level", 0.17, 0.20),
          ("aten::clone", 0.25, 0.26),
          ("dbot.read.pose", 0.31, 0.35), ("aten::to", 0.31, 0.349),
          ("dbot.read.metrics", 0.35, 0.37), ("aten::item", 0.36, 0.369),
          ("dbot.loop.on_frame", 0.37, 0.392), ("aten::mul", 0.38, 0.385),
          ("aten::add", 0.395, 0.398),
          ("aten::rand", 0.45, 0.46)]
    return [(n, o + a, o + b) for n, a, b in ev]


def _device(o):
    return [("fused_loglik_kernel<1>", o + 0.12, o + 0.13),
            ("elementwise_kernel", o + 0.20, o + 0.28)]


def _spanned_trace():
    return trace.Trace(_device(0.0) + _device(0.5),
                       _frame(0.0) + _frame(0.5), window_s=1.0, frames=2)


def _run(host_trace):
    return Run(cell="pf10k.stream", kind="particle", settings={},
               traffic=None, seconds=1.0, frames=[], t_start=0.0, t_end=1.0,
               host_trace=host_trace)


def _read(name, tr):
    return spec.reader(name).read(_run(tr))


def test_launches_and_the_durations_of_the_reads():
    tr = _spanned_trace()
    # propose and level a frame; the capture is no launch
    tr.host.append(("dbot.step.capture:finish", 0.21, 0.24))
    assert _read("step.graph_launches_per_frame", tr) == pytest.approx(2.0)
    assert _read("step.read_wait_ms_per_frame", tr) == pytest.approx(30.0)
    assert _read("runtime.read_wait_ms_per_frame", tr) == pytest.approx(
        1e3 * (0.04 + 0.02))


def test_ops_by_span():
    tr = _spanned_trace()
    # empty, copy_, clone start inside dbot.track
    assert _read("trackers.host_ops_per_frame", tr) == pytest.approx(3.0)
    # to, item, add: in the frame, outside the track and the callback
    assert _read("runtime.host_ops_per_frame", tr) == pytest.approx(3.0)
    # the rest: mul (the callback's), rand (outside every span)
    whole = spec.reader("step.host_ops_per_frame").read(_run(tr))
    assert whole == pytest.approx(8.0)


def test_idle_gaps_under_no_leaf_span():
    tr = _spanned_trace()
    # gaps: [0, .12] [.13, .20] [.28, .62] [.63, .70] [.78, 1.0]. The
    # middles of the first two (.06, .165) lie under the frame and the
    # track, which name no layer, that of [.28, .62] (.45) under no span;
    # only the last's (.89) lies under a leaf, the callback of frame 2
    idle = 0.12 + 0.07 + 0.34 + 0.07 + 0.22
    assert _read("device.idle_unattributed_share", tr) == pytest.approx(
        (idle - 0.22) / idle)
    assert sum(b - a for a, b in spans.idle_gaps(tr)) == pytest.approx(idle)
    # a leaf over the first gap's middle (the upload) attributes it
    tr.host.append(("dbot.track.upload", 0.03, 0.08))
    assert _read("device.idle_unattributed_share", tr) == pytest.approx(
        (idle - 0.22 - 0.12) / idle)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_the_programs_spans(name):
    host = [e for e in _spanned_trace().host
            if not e[0].startswith("dbot.")]
    bare = trace.Trace(_device(0.0) + _device(0.5), host, window_s=1.0,
                       frames=2)
    assert _read(name, bare) is None
    assert _read(name, None) is None
    assert _read(name, trace.Trace([], _frame(0.0), 1.0, 0)) is None


def test_a_reader_of_one_span_needs_that_span():
    """A trace with the loop's spans but no ladder read (the Gaussian
    tracker's) gives no ladder wait, and every other reading."""
    tr = _spanned_trace()
    tr.host = [e for e in tr.host if e[0] != "dbot.read.ladder"]
    assert _read("step.read_wait_ms_per_frame", tr) is None
    for name in READERS:
        if name != "step.read_wait_ms_per_frame":
            assert _read(name, tr) is not None, name


def test_the_span_readers_are_in_the_benchmark():
    entries = {m["name"]: m for m in spec.bench()["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "program_span" and m["moves"] == "frames_per_s"
        assert set(m["workloads"]) <= {"pf10k.stream", "rgf6.stream"}
