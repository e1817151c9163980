"""Host `aten::` operations per frame in the stretch that records them,
the traced stretch's last (counted as `chip_smoke.py` `profile_steps`
counts them)."""

from portbench.core.readers import per_frame


def read(run):
    if run.host_trace is None:
        return None
    return per_frame(run.host_trace, run.host_trace.count_host_ops())
