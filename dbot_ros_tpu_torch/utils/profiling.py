"""Lightweight timing and printing helpers (ref: fl/util/profiling.hpp).

Port of ``dbot_ros_tpu/utils/profiling.py``. The reference's
``INIT_PROFILING`` / ``MEASURE("label")`` / ``PV(x)`` wall-clock macros
become helpers that understand asynchronous CUDA launches: a measurement
that should include the device's work waits for it with
``torch.cuda.synchronize`` on every CUDA device that holds one of the
given tensors (tensors on the CPU are already computed). For kernel
times use CUDA events or ``torch.profiler``; these helpers are the
printf-style layer.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def pv(name, value):
    """Print-value helper (ref: the PV macro)."""
    print(f"{name}: {value}")
    return value


def wait_for(outputs) -> None:
    """Wait until the device work producing ``outputs`` (a tensor, or
    lists, tuples and dicts of them) has finished."""
    devices = set()
    stack = [outputs]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


class Stopwatch:
    """INIT_PROFILING/MEASURE analog that waits for the device.

    >>> sw = Stopwatch()
    >>> out = step(belief, frame)
    >>> sw.measure("filter step", out)    # waits for `out`, prints ms
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def measure(self, label: str, block_on=None, reset: bool = True):
        """Print and return the seconds since the last reset, after the
        device work behind ``block_on`` has finished."""
        if block_on is not None:
            wait_for(block_on)
        dt = time.perf_counter() - self._t0
        print(f"{label}: {dt * 1000:.3f} ms")
        if reset:
            self.reset()
        return dt


@contextlib.contextmanager
def measure(label: str, block_on_result: Optional[list] = None):
    """Context-manager timing; append device outputs to the yielded list
    to include their completion in the measurement."""
    t0 = time.perf_counter()
    out: list = block_on_result if block_on_result is not None else []
    yield out
    if out:
        wait_for(out)
    print(f"{label}: {(time.perf_counter() - t0) * 1000:.3f} ms")
