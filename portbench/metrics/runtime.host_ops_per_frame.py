"""Host `aten::` ops a frame that start inside the loop's handling of a
frame (span `dbot.loop.frame`, host trace) but outside the tracker's call
(`dbot.track`) and the caller's callback (`dbot.loop.on_frame`): the
loop's own reads and bookkeeping."""

from portbench.core.spans import ops_per_frame


def read(run):
    return ops_per_frame(run, ("dbot.loop.frame",),
                         ("dbot.track", "dbot.loop.on_frame"))
