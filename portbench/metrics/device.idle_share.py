"""The device's idle share of the loop as it runs untraced: 1 - the
device's busy time a frame in the device trace times the frames a second
before the traced stretch (host clock). The trace slows the loop (CUPTI
records every kernel); that stretches the host's side and the idle gaps,
not the device's work a frame, so the trace's own idle share would read
the profiler."""


def read(run):
    tr = run.trace
    if tr is None or not tr.frames or not run.untraced_fps:
        return None
    return 1.0 - tr.busy_s() / tr.frames * run.untraced_fps
