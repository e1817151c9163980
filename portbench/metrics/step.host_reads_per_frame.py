"""Copies from the device to the host (`Memcpy DtoH`) per frame in the
device trace: the ladder and pose reads and the loop's scalar reads."""

from portbench.core.readers import per_frame


def read(run):
    if run.trace is None:
        return None
    return per_frame(run.trace, run.trace.count_device("Memcpy DtoH"))
