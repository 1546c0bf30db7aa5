"""Device kernels per Krylov iteration over the traced stretch, counted in
the profiler's trace (memory copies and sets left out).  Layer: the solver
loop, whose host loop launches them."""

UNIT = "launches"
LAYER = "solver loop"
MOVES = "ms_per_iter"


def read(run):
    if run.stretch is None or not run.stretch_iterations:
        return None
    return len(run.stretch.kernels) / run.stretch_iterations
