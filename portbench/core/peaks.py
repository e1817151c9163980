"""Published peaks of one NVIDIA H100 (SXM, NVIDIA's data sheet, dense,
at the 700 W power limit) and the card's own power limit, which is
written beside every share of a peak."""

from __future__ import annotations

import subprocess

PEAK_BYTES_PER_S = 3.35e12          # HBM3
PEAK_F32_FLOPS = 67e12              # float32 outside the tensor cores


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 rate and the bytes over the memory rate."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def power_limit_w():
    """The card's power limit in watts (``nvidia-smi``), None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
