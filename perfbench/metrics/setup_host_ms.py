"""Host milliseconds per solve spent in the solve outside its Krylov
iterations: each ``solve`` span of the traced stretch less its
``krylov.iteration`` children, summed and divided by the stretch's solves.
This is the field cast, the operator build with its tuning-cache lookup,
the loop's set-up (``krylov.init``) and the result's assembly, with any
wait on the card that they make.  Layer: the solve set-up
(``core/bicgstab.solve_block``)."""

from perfbench.spans import host_ms

UNIT = "ms"
LAYER = "solve set-up"
MOVES = "solve_s"


def read(run):
    ms = host_ms(run, "solve", "krylov.iteration")
    return None if ms is None else ms / len(run.stretch_solves)
