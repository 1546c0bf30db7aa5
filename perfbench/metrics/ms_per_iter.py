"""Milliseconds per Krylov iteration: the window's host time over every
iteration its solves ran.
The paper's figure of merit; it carries each solve's set-up (the field
cast, the operator build) spread over its iterations."""

UNIT = "ms"


def read(run):
    return run.window_s / run.iterations * 1e3 if run.iterations else None
