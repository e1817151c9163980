"""Named spans of the program's host work, recorded by a running profiler.

Departs from ``dbot_ros_tpu/utils/profiling.py`` (ref:
fl/util/profiling.hpp), whose ``PV`` / ``Stopwatch`` / ``measure`` print
wall-clock times after blocking on the computation. Here a span keeps no
clock and prints nothing: :func:`span` marks where a piece of the loop,
the trackers or the step program runs, and ``torch.profiler`` records it
as a host event of that name, in the same event stream as the aten ops
and the device's kernels, on their clock. Without a running profiler a
span costs one flag test and enters nothing.

A span is recorded as an op (``torch._C._profiler._RecordFunctionFast``),
not as a user annotation (``torch.autograd.profiler.record_function``):
the profiler copies a user annotation onto the device's timeline as an
event over the kernels launched inside it, which makes the device look
busy through every span, and a user annotation costs about five times as
much to record.

Spans are switched on by nothing but a running profiler: an operator
who wants them wraps the loop in one::

    with torch.profiler.profile() as prof:
        node.run(tracker, source)
    prof.export_chrome_trace("trace.json")

Names start with ``dbot.``; a key follows a colon
(``dbot.step.run:propose``). The profiler records only the thread that
started it, and a CUDA graph's replay runs no Python: code inside a
captured graph, or on a camera thread, carries no span.
"""

from __future__ import annotations

import torch
from torch.autograd import profiler as _profiler

_Recorded = torch._C._profiler._RecordFunctionFast


class _Off:
    """The span of a process with no profiler running: enters nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, key=None):
    """A context manager marking the host work inside it as ``name``
    (``name:key`` where ``key`` is given) for a running profiler; a no-op
    singleton when none runs, so that the name is not even built."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recorded(name if key is None else f"{name}:{key}")
