"""Fused-sensor calls a frame at a ladder level past the tightest, as the
host trace counts them: the program's spans `dbot.sensor.level:<level>`
(one a sensor call, after its ladder read) with a level of 1 or more,
per frame posed in the host trace. None where the trace has no such
span (a program that does not mark its level)."""

from portbench.core.spans import traced

SPAN = "dbot.sensor.level"


def read(run):
    tr = traced(run, SPAN)
    if tr is None:
        return None
    wide = sum(1 for name, _, _ in tr.host
               if name.startswith(SPAN + ":")
               and int(name[len(SPAN) + 1:]) >= 1)
    return wide / tr.frames
