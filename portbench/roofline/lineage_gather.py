"""The work the lineage gather needs on one frame, counted from the
problem's sizes: the occlusion map's P columns of N pixels (bfloat16)
read once and written once, and the P parents (int32). The particle
step runs it after every coordinate block, K times a frame of K tracked
objects (``_maybe_resample`` selects the identity where it does not
resample). No arithmetic.
"""

NAMES = ("lineage_gather_kernel",)


def work(run, frame):
    flops, nbytes = work_at(run.num_pixels, run.num_particles)
    return run.objects * flops, run.objects * nbytes


def work_at(pixels, particles):
    n, p = float(pixels), float(particles)
    return 0.0, 2 * 2 * n * p + 4 * p
