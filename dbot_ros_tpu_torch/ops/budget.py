"""Device-memory budgeting for particle configurations.

Port of ``dbot_ros_tpu/ops/budget.py``: estimate the device-memory
footprint of a tracker configuration (belief + per-frame constants +
kernel workspaces) against the card's capacity, recommend the largest
particle count that fits, and degrade the exact raycaster's triangle
chunk to the particle count. The estimate's formulas are the
reference's, so both packages give the same numbers; the capacity is the
CUDA device's own (``torch.cuda``), and asking for it without a CUDA
device raises.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch


@dataclasses.dataclass
class MemoryEstimate:
    belief_bytes: int          # states + weights + occlusion map
    constants_bytes: int       # per-frame transformed triangle slabs
    workspace_bytes: int       # intermediates of the sensor backend
    total_bytes: int

    def human(self) -> str:
        return (f"belief={self.belief_bytes / 1e6:.0f}MB "
                f"constants={self.constants_bytes / 1e6:.0f}MB "
                f"workspace={self.workspace_bytes / 1e6:.0f}MB "
                f"total={self.total_bytes / 1e6:.0f}MB")


def _round_up(x, m):
    return (x + m - 1) // m * m


def estimate_memory(num_particles: int, num_pixels: int,
                    padded_triangles: int, num_objects: int = 1,
                    backend: str = "pallas") -> MemoryEstimate:
    p = num_particles
    belief = p * num_objects * 13 * 4 + p * 4 + p * num_pixels * 4
    if backend in ("pallas", "deferred"):
        p_pad = _round_up(p, 128)
        constants = padded_triangles * 10 * p_pad * 4
    else:
        constants = padded_triangles * 10 * p * 4  # G + t_num per chunk
    if backend == "pallas":
        n_pad = _round_up(num_pixels, 64)
        workspace = 2 * n_pad * _round_up(p, 128) * 4  # map in and out
    elif backend == "deferred":
        workspace = num_pixels * p * 10 * 4            # selected constants
    else:
        workspace = num_pixels * p * 4                 # depth images
    total = belief + constants + workspace
    return MemoryEstimate(belief, constants, workspace, total)


def device_memory_bytes(device=None) -> int:
    """Total memory of the CUDA ``device`` (default: the current one)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device_memory_bytes needs a CUDA device; on the CPU pass "
            "budgets explicitly (xla_tri_chunk(budget_bytes=...))")
    return int(torch.cuda.get_device_properties(
        torch.device("cuda" if device is None else device)).total_memory)


def max_particles(num_pixels: int, padded_triangles: int,
                  num_objects: int = 1, backend: str = "pallas",
                  memory_fraction: float = 0.6, device=None,
                  capacity_bytes: int = None) -> int:
    """Largest particle count whose footprint fits in the budget
    (``memory_fraction`` of ``capacity_bytes``, default the device's
    total memory). Callers pass their requested ``evaluation_count``
    through ``min(requested, max_particles(...))``."""
    if capacity_bytes is None:
        capacity_bytes = device_memory_bytes(device)
    budget = capacity_bytes * memory_fraction
    lo, hi = 128, 1 << 22
    while lo < hi:
        mid = (lo + hi + 1) // 2
        est = estimate_memory(mid, num_pixels, padded_triangles,
                              num_objects, backend)
        if est.total_bytes <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def check_fit(num_particles: int, num_pixels: int, padded_triangles: int,
              num_objects: int = 1, backend: str = "pallas",
              device=None, capacity_bytes: int = None) -> MemoryEstimate:
    """Estimate + warn (returns the estimate either way)."""
    est = estimate_memory(num_particles, num_pixels, padded_triangles,
                          num_objects, backend)
    cap = (device_memory_bytes(device) if capacity_bytes is None
           else capacity_bytes)
    if est.total_bytes > 0.9 * cap:
        warnings.warn(
            f"particle configuration needs {est.total_bytes / 1e9:.1f} GB "
            f"of ~{cap / 1e9:.0f} GB device memory ({est.human()}); "
            f"consider max_particles() to degrade-to-fit", RuntimeWarning)
    return est


def rgf_pixel_stride(num_pixels: int, padded_triangles: int,
                     num_objects: int = 1, iterations: int = 3,
                     budget_gflops: float = 5.0, max_stride: int = 64
                     ) -> int:
    """Degrade-to-fit for the Gaussian tracker: the smallest power-of-two
    ``pixel_stride`` that keeps the estimated sigma-point raycast cost of
    one frame ((2·12K+1) sigma poses × pixels × triangles × (iterations
    + 1), ≈ 60 flops per ray-triangle test) under ``budget_gflops``."""
    n_sigma = 2 * 12 * num_objects + 1
    per_px = n_sigma * padded_triangles * (iterations + 1) * 60
    total = per_px * num_pixels
    stride = 1
    while (total / stride > budget_gflops * 1e9
           and stride < max_stride):
        stride *= 2
    return stride


# workspace of a render on the host (a CPU device has no capacity to ask)
HOST_WORKSPACE_BYTES = 2 * 1024 ** 3


def xla_tri_chunk(num_particles: int, num_pixels: int,
                  requested: int = 512,
                  budget_bytes: int = HOST_WORKSPACE_BYTES,
                  min_chunk: int = 16) -> int:
    """Degrade the exact raycaster's triangle chunk to the particle count.

    ``raycast_depth`` materializes a (P, N, chunk) float32 intermediate;
    shrink the chunk so it stays under ``budget_bytes``. The per-frame
    work is unchanged, only the loop gets more steps. The name is the
    reference's (its ``"xla"`` backend)."""
    per_chunk = max(num_particles * num_pixels * 4, 1)
    fit = int(budget_bytes // per_chunk)
    degraded = max(min_chunk, (fit // 16) * 16)
    requested = int(requested)
    if requested <= 0:                  # non-positive = "auto"
        return degraded
    # degrade-only: never raise an explicitly tiny (but valid) request
    return min(requested, degraded)


# float32 values alive per (pixel, candidate, particle) at the peak of the
# candidate-set render (ops/deferred.py): the ten selected constants, the
# three numerators and the inside-test's intermediates
_DEFERRED_LIVE_VALUES = 32
# the share of the capacity that one chunk's intermediates may take
_DEFERRED_MEMORY_FRACTION = 0.1
# a chunk of the particle axis is a multiple of this (the fused sensor's
# particle padding)
_CHUNK_MULTIPLE = 128


def deferred_particle_chunk(num_particles: int, num_pixels: int,
                            num_candidates: int = 4, device=None,
                            capacity_bytes: int = None) -> int:
    """How many particles the ``"deferred"`` sensor renders at once.

    Eager PyTorch materializes every intermediate of the candidate-set
    render, ``_DEFERRED_LIVE_VALUES`` float32 values per (pixel,
    candidate, particle); the particles are rendered in chunks so that
    these stay under a tenth of ``capacity_bytes`` (default: the CUDA
    device's total memory; CPU callers pass it). The chunk is a multiple
    of 128 (at least 128), or all particles when they fit. The results
    do not depend on it."""
    if capacity_bytes is None:
        capacity_bytes = device_memory_bytes(device)
    budget = capacity_bytes * _DEFERRED_MEMORY_FRACTION
    per_particle = num_pixels * num_candidates * _DEFERRED_LIVE_VALUES * 4
    fit = int(budget // max(per_particle, 1))
    chunk = max(fit // _CHUNK_MULTIPLE * _CHUNK_MULTIPLE, _CHUNK_MULTIPLE)
    return int(num_particles) if fit >= num_particles else min(
        chunk, int(num_particles))
