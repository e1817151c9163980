"""The work the fused sensor's row kernels need on one frame, counted
from the problem's sizes (not from the port's buffers): at a compacted
level of its ladder a coordinate block gathers the occlusion rows of the
pixels it scores into a dense block (``gather_pixel_rows``) and scatters
their posterior rows back (``scatter_pixel_rows``). The rows that score
are the frame's ``n_active`` (the reference's own candidate pass at the
frame's true poses, ``ParticleReference.candidate_counts``), each of P
bfloat16 values, read once and written once by each kernel: ``4 · 2 ·
n_active · P`` bytes a block, no arithmetic. The level's padding rows
are not counted, so the count stays under what the kernels move. A frame
whose level is the full one runs neither kernel and counts nothing; a
frame of K tracked objects runs K blocks (the level is the last
block's).

The ladder is the fused sensor's (``FusedSensor``): ``backend_options``'
``levels`` and ``nb`` where the configuration gives them, else its
defaults; :func:`pixel_caps` gives each level's row budget.
"""

import math

NAMES = ("gather_rows", "scatter_rows_kernel")
# ``FusedSensor``'s defaults: (pixel share, triangle share) per level,
# tightest first, and the pixel block the row budgets round up to
LEVELS = ((1.0 / 12.0, 0.2), (0.5, 0.75))
NB = 64


def pixel_caps(run):
    """The rows each ladder level runs the kernel on at the run's pixel
    count, tightest first, the full level last: every pixel, as at a
    level that compacts its triangles only. A level that compacts
    neither ends the ladder, as ``FusedSensor.caps`` ends it."""
    opts = run.settings.get("backend_options") or {}
    n, nb = run.num_pixels, int(opts.get("nb", NB))
    caps = []
    for pf, tf in opts.get("levels") or LEVELS:
        pcap = min(-(-math.ceil(n * pf) // nb) * nb, n)
        if pcap == n and tf >= 1.0:
            break
        caps.append(pcap)
    return caps + [n]


def work(run, frame):
    """(operations, bytes) of one frame, or None without its counts or
    its level."""
    if frame.counts is None or frame.level is None:
        return None
    if pixel_caps(run)[frame.level] >= run.num_pixels:
        return 0.0, 0.0
    return 0.0, run.objects * work_at(frame.counts[0], run.num_particles)


def work_at(n_active, particles):
    return 4.0 * 2.0 * float(n_active) * float(particles)
