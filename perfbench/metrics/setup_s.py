"""Seconds from the start of the process to the start of the window:
imports, the CUDA context, loading (on a checkout's first run, building)
the kernel library, making the inputs, and the warm solve."""

UNIT = "s"


def read(run):
    return run.setup_s
