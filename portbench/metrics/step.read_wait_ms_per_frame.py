"""Host ms a frame inside the step's one host read, the fused sensor's
ladder read (span `dbot.read.ladder`, host trace): the wait for the
`propose` graph."""

from portbench.core.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "dbot.read.ladder")
