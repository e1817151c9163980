"""The fused sensor's row kernels' share of their roofline over the
traced stretch: the least time of the rows the frames score, gathered
and scattered (the benchmark's count, `portbench/roofline/pixel_rows.py`,
over the published H100 peaks), over the device time of the row
kernels `gather_rows_*` and `scatter_rows_kernel` in the trace, in %."""

from portbench.core.readers import roofline_share


def read(run):
    return roofline_share(run, "pixel_rows")
