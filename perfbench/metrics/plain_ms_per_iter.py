"""Device milliseconds per Krylov iteration in kernels that are not the
program's hand-written ones (the ``__global__`` functions of its CUDA
sources): the zero pads, the SpMV input ``q``, the field casts, plain AXPYs
and reductions.  Layer: the operator and halo, and the solvers' plain ops."""

UNIT = "ms"
LAYER = "operator and halo"
MOVES = "ms_per_iter"


def read(run):
    if run.stretch is None or not run.stretch_iterations:
        return None
    plain = sum(k.seconds for k in run.stretch.kernels if k.base not in run.handwritten)
    return plain / run.stretch_iterations * 1e3
