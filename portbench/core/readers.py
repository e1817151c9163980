"""Arithmetic the per-layer readers share (each reader is its own file
under ``portbench/metrics/``). A reader returns None where its run has
nothing to read; it never returns 0 for a share of a peak."""

from __future__ import annotations

import statistics

from portbench.core import peaks, spec


def median_ms(values):
    values = [v for v in values if v is not None]
    return 1e3 * statistics.median(values) if values else None


def track_ms_p50(run):
    """Median host time of ``track`` (until it returns, its own host
    reads included) over the window's frames outside the traced
    stretch."""
    return median_ms([f.track1 - f.track0 for f in run.untraced()
                      if f.track0 is not None])


def per_frame(trace, count):
    """``count`` events of ``trace`` per frame posed in it."""
    if trace is None or trace.frames == 0:
        return None
    return count / trace.frames


def roofline_seconds(run, kernel):
    """(least seconds the counted work of the traced frames needs, the
    device seconds of the kernel's operations in the trace), or None."""
    if run.trace is None:
        return None
    mod = spec.work_count(kernel)
    least = 0.0
    for f in run.traced_frames():
        w = mod.work(run, f)
        if w is None:
            return None
        least += peaks.least_seconds(*w)
    took = sum(b - a for _, a, b in run.trace.device_named(mod.NAMES))
    if took <= 0.0 or least <= 0.0:
        return None
    return least, took


def roofline_share(run, kernel):
    got = roofline_seconds(run, kernel)
    return None if got is None else 100.0 * got[0] / got[1]
