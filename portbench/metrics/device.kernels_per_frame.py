"""Device operations per frame in the device trace."""

from portbench.core.readers import per_frame


def read(run):
    if run.trace is None:
        return None
    return per_frame(run.trace, run.trace.count_device())
