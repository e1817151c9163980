"""The end-to-end metrics and the result line of a run."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.core import peaks


def p95_ms(values):
    """The 95th percentile in ms: the least value with 95 % of the set at
    or below it (numpy's ``inverted_cdf``); an infinite value (a frame
    lost) counts as missing every limit."""
    if not values:
        return None
    return 1e3 * float(np.percentile(np.asarray(values, np.float64), 95,
                                     method="inverted_cdf"))


def _finite(pose):
    return pose is not None and bool(np.all(np.isfinite(pose)))


def end_to_end(run, setup_s) -> dict:
    """Every end-to-end metric this run can give, by name."""
    done = run.window_frames
    out = {"setup_s": setup_s}
    if run.traffic.loop == "closed":
        if done:
            last = max(f.done for f in done)
            out["frames_per_s"] = len(done) / (last - run.t_start)
            out["frame_ms_p95"] = p95_ms([f.done - f.hand for f in done])
    else:
        posed = {f.index: f for f in done if _finite(f.pose)}
        lat = [posed[k].done - (run.t_start + k / run.traffic.rate_hz)
               if k in posed else math.inf for k in range(run.offered)]
        out["live_ms_p95"] = p95_ms(lat)
    return out


def attempted_failed(run):
    done = run.window_frames
    bad = sum(1 for f in done if not _finite(f.pose))
    if run.traffic.loop == "closed":
        return len(run.frames), bad + (len(run.frames) - len(done))
    return run.offered, run.offered - len(done) + bad


def result(run, spec, traced, setup_s, peak, device, verdict) -> dict:
    dev = torch.device(device)
    metrics = {}
    if not traced:
        got = end_to_end(run, setup_s)
        for m in spec.end_to_end(run.cell):
            v = got.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec.per_layer(run.cell):
            v = spec.reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted, failed = attempted_failed(run)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_info["power_limit_w"] = peaks.power_limit_w()
    out = {"correct": bool(verdict.correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device_info}
    if traced and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_device_ops()}
        if run.host_trace is not None:
            # named by the host's ops: read where they are recorded
            out["breakdown"]["idle_gaps"] = run.host_trace.idle_gaps()
    out["info"] = {"frames": len(run.window_frames),
                   "checked_frames": verdict.frames,
                   "notes": verdict.notes,
                   "uncompared": verdict.uncompared(),
                   "camera_lateness_ms": 1e3 * run.camera_lateness_s,
                   "traced_frames": {
                       "device": run.trace.frames if run.trace else 0,
                       "host": (run.host_trace.frames if run.host_trace
                                else 0)}}
    out["checks"] = verdict.table()
    return out
