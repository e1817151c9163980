"""The step program's graph launches a frame (the spans
`dbot.step.run:<key>`, host trace): one `cudaGraphLaunch` each, or the
eager run where a program does not capture. A capture is not counted
(`dbot.step.capture:<key>`). Counted, not timed: CUPTI records each node
of a replayed graph during its launch, which stretches the launch."""

from portbench.core.spans import count_per_frame


def read(run):
    return count_per_frame(run, "dbot.step.run")
