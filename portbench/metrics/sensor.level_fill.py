"""Share of the rows the fused sensor launched at its chosen ladder level
that score: the pixels with a candidate triangle (`FrameRec.counts`, the
reference's `n_active` at the frame's true poses) summed over the frames
of the device trace, over the row budget of each frame's level
(`FusedSensor.last_level`) summed over the same frames; the full level
counts every pixel. The rest is padding that a finer ladder would save.
The budgets are the configuration's ladder at the run's pixel count
(`portbench/roofline/pixel_rows.py` `pixel_caps`)."""

from portbench.core import spec


def read(run):
    frames = [f for f in run.traced_frames()
              if f.counts is not None and f.level is not None]
    if not frames:
        return None
    caps = spec.work_count("pixel_rows").pixel_caps(run)
    return (sum(f.counts[0] for f in frames)
            / sum(caps[f.level] for f in frames))
