"""Share of the window's frames whose fused-sensor ladder level
(`FusedSensor.last_level`) is past the tightest."""


def read(run):
    levels = [f.level for f in run.window_frames if f.level is not None]
    if not levels:
        return None
    return sum(1 for x in levels if x > 0) / len(levels)
