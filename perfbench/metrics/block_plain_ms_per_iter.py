"""Device milliseconds per block iteration in kernels that are not the
program's hand-written ones (the ``__global__`` functions of its CUDA
sources): on the block's path the second SpMV's input ``q`` formed by plain
ops for the whole block, the per-solve field cast, and any per-RHS freeze
merge.  Layer: the operator and halo, and the solvers' plain ops."""

from perfbench.metrics.plain_ms_per_iter import read  # noqa: F401  (the same reading)

UNIT = "ms"
LAYER = "operator and halo"
MOVES = "ms_per_iter"
