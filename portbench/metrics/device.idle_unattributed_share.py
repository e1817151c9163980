"""The share of the host trace's device-idle time (the gaps between the
union of device operations, as `Trace.idle_gaps` takes them) whose gap has
its middle under no leaf span of the program: under no `dbot.*` span but
the frame's (`dbot.loop.frame`) and the tracker's call
(`dbot.track`), which hold the leaves and name no layer. Idle time that
no layer of the program names."""

from portbench.core.spans import idle_unattributed_share


def read(run):
    return idle_unattributed_share(run)
