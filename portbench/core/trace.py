"""The device trace of a traced run, reduced to what the per-layer
readers and the result's ``device`` and ``breakdown`` take.

``torch.profiler`` (CUPTI) traces a stretch at the end of the window,
first with the recording of host ops switched off (the device trace),
then on (the host trace; it slows the loop). The counts follow
``chip_smoke.py`` ``profile_steps`` (copied here so the yardstick stays
put): device operations are the events on the CUDA
device (kernels, copies, fills), host operations the CPU events named
``aten::*``, host reads the device events named ``Memcpy DtoH``. Busy
time is the union of the device events' intervals; an idle gap is named
after the innermost host event that covers its middle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import List, Tuple

# gaps named one by one, longest first; the rest are summed unnamed
NAMED_GAPS = 5000
TOP = 10


@dataclasses.dataclass
class Trace:
    """Events of the traced stretch, times in seconds from its start."""

    device: List[Tuple[str, float, float]]      # (name, start, end)
    host: List[Tuple[str, float, float]]
    window_s: float                              # the stretch's wall time
    frames: int                                  # frames posed in it

    def device_named(self, parts) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if any(p in e[0] for p in parts)]

    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.device))

    def count_host_ops(self) -> int:
        return sum(1 for e in self.host if e[0].startswith("aten::"))

    def count_device(self, part=None) -> int:
        if part is None:
            return len(self.device)
        return sum(1 for e in self.device if part in e[0])

    def top_device_ops(self, n=TOP):
        by = collections.defaultdict(float)
        for name, a, b in self.device:
            by[name[:120]] += b - a
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=TOP):
        """The idle time between device operations, summed by the host
        event that covered each gap's middle (the innermost one), longest
        first."""
        busy = _union(self.device)
        edges = [0.0] + [x for iv in busy for x in iv] + [self.window_s]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        by = collections.defaultdict(float)
        for a, b in gaps[:NAMED_GAPS]:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            best = None
            for j in range(i - 1, max(i - 400, -1), -1):
                name, s, e = host[j]
                if e >= mid and (best is None or e - s < best[2] - best[1]):
                    best = host[j]
            by["host idle" if best is None else best[0][:120]] += b - a
        rest = sum(b - a for a, b in gaps[NAMED_GAPS:])
        if rest:
            by["(shorter gaps)"] += rest
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def _union(events):
    iv = sorted((a, b) for _, a, b in events)
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def events(prof):
    """A stopped ``torch.profiler.profile`` → its events as (name, on the
    device, start ns, end ns)."""
    from torch.autograd import DeviceType

    raw = []
    results = getattr(getattr(prof, "profiler", None), "kineto_results",
                      None)
    if results is not None:
        for e in results.events():
            raw.append((e.name(), e.device_type() == DeviceType.CUDA,
                        e.start_ns(), e.start_ns() + e.duration_ns()))
    else:
        for e in prof.events():
            raw.append((e.name, e.device_type == DeviceType.CUDA,
                        int(e.time_range.start * 1e3),
                        int(e.time_range.end * 1e3)))
    return raw


def _trace(raw, t0_ns, window_s, frames) -> Trace:
    dev, host = [], []
    for name, on_dev, a, b in raw:
        ev = (name, (a - t0_ns) * 1e-9, (b - t0_ns) * 1e-9)
        (dev if on_dev else host).append(ev)
    return Trace(dev, host, float(window_s), int(frames))


def split(raw, mark: str, device_s: float, host_s: float,
          device_frames: int, host_frames: int):
    """The events of one profiler run, cut at the first event named
    ``mark`` (where the recording of host ops was switched on) into the
    device trace before it (``device_s`` long, ``device_frames`` frames,
    times from its first event) and the host trace from it (None
    without the mark)."""
    cut = min((a for name, _, a, _ in raw if name == mark), default=None)
    before = [r for r in raw if cut is None or r[2] < cut]
    t0 = min((r[2] for r in before), default=0)
    device = _trace(before, t0, device_s, device_frames)
    if cut is None:
        return device, None
    after = [r for r in raw if r[2] >= cut and r[0] != mark]
    return device, _trace(after, cut, host_s, host_frames)
