"""Host milliseconds per Krylov iteration that the solver loop spends
outside its one wait on the card: each ``krylov.iteration`` span of the
traced stretch less its ``krylov.flag_wait`` child, summed and divided by
the stretch's iterations.  This is the host's enqueue of the step's
kernels and plain ops, the Python between them, and the spans' own cost.
Layer: the solver loop (``core/solvers/common.run_krylov``)."""

from perfbench.spans import host_ms

UNIT = "ms"
LAYER = "solver loop"
MOVES = "ms_per_iter"


def read(run):
    ms = host_ms(run, "krylov.iteration", "krylov.flag_wait")
    return None if ms is None else ms / run.stretch_iterations
