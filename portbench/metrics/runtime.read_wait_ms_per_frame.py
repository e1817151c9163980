"""Host ms a frame inside the loop's reads (spans `dbot.read.pose` and
`dbot.read.metrics` of `runtime.node.run`, host trace): the wait for the
step's last graph and the step info's scalars."""

from portbench.core.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "dbot.read.pose", "dbot.read.metrics")
