"""The particle step's share of the card's peak: the least time of the
counted work of every kernel with a count (`portbench/roofline/`) a frame
of the device trace, times the frames a second before the traced stretch
(host clock: the loop as it runs untraced), in %. It bounds what any one
kernel's roofline can give end to end."""

from portbench.core.readers import roofline_seconds

KERNELS = ("fused_loglik", "lineage_gather")


def read(run):
    tr = run.trace
    if tr is None or not tr.frames or not run.untraced_fps:
        return None
    least = 0.0
    for k in KERNELS:
        got = roofline_seconds(run, k)
        if got is None:
            return None
        least += got[0]
    return 100.0 * least / tr.frames * run.untraced_fps
