"""Median host ms of a `track` call in the live cell (benchmark clock
around the call, through the pass-through proxy handed to the loop)."""

from portbench.core.readers import track_ms_p50


def read(run):
    return track_ms_p50(run)
