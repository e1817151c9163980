"""The work the fused likelihood needs on one frame, counted from the
problem's sizes (not from the port's buffers): a frame of K tracked
objects runs the kernel K times, once a coordinate block, each over the
table of every object's candidates; each call, for the pixels that score
(``n_active``) and the P particles (not the padded width), reads each
input byte once and writes each output byte once. The frame's counts
(``n_active``, ``n_uniq``, the latter over every mesh's triangles) come
from the reference's own candidate pass at the frame's true poses
(``ParticleReference.candidate_counts``), not from the program:

* the occlusion rows of those pixels, read and written in bfloat16;
* the transformed constants (10 float32) of every triangle the frame's
  candidate table names (``n_uniq``), for each particle;
* each pixel's observed depth, ray (3), candidate ids and age;
* one float32 log-likelihood per particle.

Operations: per (pixel, particle) 31 for each candidate triangle (three
3-term dot products, the inside tests, one division, the running
minimum) and 50 for the beam likelihood and the occlusion posterior, a
transcendental counted as one (the arithmetic of ``chip_smoke.py``
``fused_bound``). The kernel's device operations are the fused kernel
and the fixed-order sum of its partial sums.
"""

NAMES = ("fused_loglik_kernel", "sum_partials_kernel")
FLOPS_PER_CANDIDATE = 31
FLOPS_PER_PIXEL = 50


def work(run, frame):
    """(operations, bytes) of one frame, or None without its counts."""
    if frame.counts is None:
        return None
    flops, nbytes = work_at(frame.counts[0], frame.counts[1],
                            run.num_particles, num_candidates(run))
    return run.objects * flops, run.objects * nbytes


def num_candidates(run):
    opts = run.settings.get("backend_options") or {}
    return int(opts.get("num_candidates", 2))


def work_at(n_active, n_uniq, particles, candidates):
    n, p = float(n_active), float(particles)
    nbytes = (2 * 2 * n * p                     # occlusion rows, in and out
              + 10 * 4 * float(n_uniq) * p      # triangle constants
              + n * (4 + 12 + 4 * candidates + 4)
              + 4 * p)                          # log-likelihoods
    flops = n * p * (FLOPS_PER_CANDIDATE * candidates + FLOPS_PER_PIXEL)
    return flops, nbytes
