"""Right-hand sides served per batched SpMV launch over the traced stretch:
the program's counter ``kernels.stencil_nd_batched.rhs`` over its batched
stencil launches (``repro_torch.kernels.stencil_nd.kernel``), both read
before and after each step of the stretch.  It reads the block's B while
every SpMV serves the whole block in one launch, and less where the block
is split.  Layer: the operator and halo (``core/operator.fused_operator``
hands the batch to the kernel).  A program without the counter gives None."""

UNIT = "rhs"
LAYER = "operator and halo"
MOVES = "ms_per_iter"


def read(run):
    f = run.facts
    rhs, launches = f.get("stencil_nd_batched_rhs"), f.get("stencil_nd_batched_launches")
    if run.stretch is None or rhs is None or not launches:
        return None
    return rhs / launches
