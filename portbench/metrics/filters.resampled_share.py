"""Share of the window's frames on which the particle filter resampled
(`StepInfo.resampled`, as the loop's metrics read it)."""


def read(run):
    flags = [f.resampled for f in run.window_frames
             if f.resampled is not None]
    if not flags:
        return None
    return sum(1 for x in flags if x) / len(flags)
