"""Per-frame tracking metrics.

The port's own copy of ``dbot_ros_tpu/runtime/metrics.py``: structured
per-frame records (log-likelihood, ESS, resample events, inlier rate,
step latency) and their log, written as JSONL. ``from_info`` reads either
filter's StepInfo by field name; 0-d tensors convert through ``float``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional


@dataclasses.dataclass
class FrameMetrics:
    frame: int
    latency_s: float
    ess: Optional[float] = None           # particle filter
    kl: Optional[float] = None
    resampled: Optional[bool] = None
    mean_loglik: Optional[float] = None
    mean_beta: Optional[float] = None     # gaussian filter inlier rate
    innovation_rms: Optional[float] = None
    skipped: Optional[int] = None         # frames dropped by a push source
    # racing init-hypothesis count during an island trial (per-frame
    # latency multiplies by it)
    trial_hypotheses: Optional[int] = None

    @classmethod
    def from_info(cls, frame: int, info, latency_s: float):
        """Build from either filter's StepInfo."""
        def get(name):
            v = getattr(info, name, None)
            return None if v is None else float(v)

        resampled = getattr(info, "resampled", None)
        return cls(
            frame=frame, latency_s=latency_s,
            ess=get("ess"), kl=get("kl"),
            resampled=None if resampled is None else bool(resampled),
            mean_loglik=get("mean_loglik"), mean_beta=get("mean_beta"),
            innovation_rms=get("innovation_rms"))


class MetricsLog:
    def __init__(self):
        self.records: List[FrameMetrics] = []

    def append(self, m: FrameMetrics):
        self.records.append(m)

    def __len__(self):
        return len(self.records)

    def mean_latency(self) -> float:
        if not self.records:
            return 0.0
        return sum(r.latency_s for r in self.records) / len(self.records)

    def steady_state_latency(self, skip: int = 2) -> float:
        """Mean latency excluding the first `skip` (warm-up) frames.

        0.0 for an empty log (a run shut down before any frame was
        tracked — e.g. a service shutdown while paused at frame 0)."""
        rs = self.records[skip:] or self.records
        if not rs:
            return 0.0
        return sum(r.latency_s for r in rs) / len(rs)

    def resample_count(self) -> int:
        return sum(1 for r in self.records if r.resampled)

    def to_jsonl(self, path: str):
        with open(path, "w") as fh:
            for r in self.records:
                fh.write(json.dumps(dataclasses.asdict(r)) + "\n")
