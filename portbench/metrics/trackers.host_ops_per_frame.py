"""Host `aten::` ops a frame that start inside the tracker's call (span
`dbot.track` of `runtime.node.run`, host trace)."""

from portbench.core.spans import ops_per_frame


def read(run):
    return ops_per_frame(run, ("dbot.track",))
