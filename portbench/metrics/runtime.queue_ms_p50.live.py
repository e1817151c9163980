"""Median ms from a frame's due time on the camera's schedule to the start
of its `track` call: the u16 conversion, the ring, the loop's poll and
hand-off (benchmark clock)."""

from portbench.core.readers import median_ms


def read(run):
    return median_ms([f.track0 - f.due for f in run.untraced()
                      if f.track0 is not None and f.due is not None])
