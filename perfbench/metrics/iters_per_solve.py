"""Krylov iterations per solve over the window, from the iteration counts
the solves return.  Layer: the solver
loop (``core/bicgstab.solve_distributed`` -> ``core/solvers``)."""

UNIT = "iters"
LAYER = "solver loop"
MOVES = "solve_s"


def read(run):
    return run.iterations / len(run.solves) if run.solves else None
