"""The fused likelihood kernel's share of its roofline over the traced
stretch: the least time of the work the frames needed (the benchmark's
count, `portbench/roofline/fused_loglik.py`, over the published H100
peaks) over the kernel's device time in the trace, in %."""

from portbench.core.readers import roofline_share


def read(run):
    return roofline_share(run, "fused_loglik")
