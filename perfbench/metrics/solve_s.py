"""Seconds per solve: the window's host time over the solves it completed,
the time to a solution after the cell's iterations."""

UNIT = "s"


def read(run):
    return run.window_s / len(run.solves) if run.solves else None
