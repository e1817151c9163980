"""Arithmetic of the per-layer metrics that read the program's own spans.

The program marks its host work with spans named ``dbot.*``
(``dbot_ros_tpu_torch/utils/profiling.py``; a key follows a colon:
``dbot.step.run:propose``), which the traced stretch's profiler records
beside the host's ``aten::`` ops and the device's operations, on their
clock. Only the host trace holds them (the device trace records no host
op), so every reader here reads ``run.host_trace``, per frame posed in
it, and returns None where that trace has no span of the names it reads.

Durations are read only of spans with no ``aten::`` op inside and no
graph replay (a read's wait): the host trace records every op, which
stretches a span made of many ops, and CUPTI records every node of a
replayed graph during the launch, which stretches a launch by tens of
times. Such spans are counted instead: by their ops, or by themselves.
"""

from __future__ import annotations

import bisect

from portbench.core.trace import _union

PREFIX = "dbot."


def _named(name: str, wanted) -> bool:
    """``name`` is one of ``wanted`` or one of them with a key."""
    return any(name == w or name.startswith(w + ":") for w in wanted)


def spans(trace, *names):
    """The host events of ``trace`` named ``names`` (with any key), as
    (start, end), in order of start."""
    return sorted((a, b) for n, a, b in trace.host if _named(n, names))


def traced(run, *names):
    """``run``'s host trace where it has frames and a span of ``names``
    (any ``dbot.`` span without names), else None."""
    tr = run.host_trace
    if tr is None or not tr.frames:
        return None
    found = any(_named(n, names) if names else n.startswith(PREFIX)
                for n, _, _ in tr.host)
    return tr if found else None


class _Cover:
    """The union of intervals, asked whether it holds a point."""

    def __init__(self, intervals):
        self.iv = _union([("", a, b) for a, b in intervals])
        self.starts = [a for a, _ in self.iv]

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.iv[i][1]


def ms_per_frame(run, *names):
    """Host ms a frame inside the spans ``names`` (None without one)."""
    tr = traced(run, *names)
    if tr is None:
        return None
    return 1e3 * sum(b - a for a, b in spans(tr, *names)) / tr.frames


def count_per_frame(run, *names):
    """Spans ``names`` a frame (None without one)."""
    tr = traced(run, *names)
    if tr is None:
        return None
    return len(spans(tr, *names)) / tr.frames


def ops_per_frame(run, within, outside=()):
    """``aten::`` ops a frame whose start lies inside a span of ``within``
    and inside none of ``outside`` (None without a ``within`` span)."""
    tr = traced(run, *within)
    if tr is None:
        return None
    inner = _Cover(spans(tr, *within))
    outer = _Cover(spans(tr, *outside) if outside else [])
    n = sum(1 for name, a, _ in tr.host
            if name.startswith("aten::") and inner.holds(a)
            and not outer.holds(a))
    return n / tr.frames


def idle_gaps(trace):
    """The device's idle gaps of ``trace`` as ``Trace.idle_gaps`` takes
    them: between the union of its device operations, from the trace's
    start to its end."""
    busy = _union(trace.device)
    edges = [0.0] + [x for iv in busy for x in iv] + [trace.window_s]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


# spans that hold leaf spans and name no layer of their own: the frame,
# and the tracker's call around its upload, step and smoothing
NOT_LEAVES = ("dbot.loop.frame", "dbot.track")


def idle_unattributed_share(run):
    """The share of the host trace's device-idle time whose gaps have
    their middle under no leaf span: under no ``dbot.`` span but those of
    ``NOT_LEAVES`` (None without a span or an idle gap). Idle time under
    a leaf is left by that leaf's layer; the rest by host work that no
    layer's span names, inside the frame or outside it."""
    tr = traced(run)
    if tr is None:
        return None
    cover = _Cover([(a, b) for n, a, b in tr.host
                    if n.startswith(PREFIX) and n not in NOT_LEAVES])
    gaps = idle_gaps(tr)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0.0:
        return None
    return sum(b - a for a, b in gaps
               if not cover.holds(0.5 * (a + b))) / idle
