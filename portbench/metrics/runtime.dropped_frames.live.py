"""Frames the live source dropped ahead of the window's frames outside
the traced stretch (`Frame.skipped`, the program's counter, which
`ThreadedSource.skipped_total` sums)."""


def read(run):
    if not run.offered:
        return None
    return float(sum(f.skipped or 0 for f in run.untraced()))
