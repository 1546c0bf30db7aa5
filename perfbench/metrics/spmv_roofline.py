"""The SpMVs' share of their HBM roofline, in per cent: the compulsory bytes
of the SpMV launches in the traced stretch, at the card's published HBM
bandwidth (3.35 TB/s on an H100; :mod:`perfbench.peaks`), over the device
time of the kernels this file attributes to the SpMV.  Layer: the kernels
(``kernels/stencil_nd`` K1/K1b; K6 where a path launches it).

Compulsory bytes of one SpMV on ``N`` points with ``F`` stored coefficient
fields, in words of the storage dtype:

* read the input vector once: ``N``;
* read each stored coefficient field once: ``F * N``;
* write the output vector once: ``N``.

Not counted: the zero-padded copy of the input and its halo (a kernel that
reads its neighbours from the unpadded vector moves neither).
"""

from perfbench.peaks import hbm_bytes_per_s

UNIT = "%"
LAYER = "kernels"
MOVES = "ms_per_iter"
#: device functions that compute an SpMV, one launch per SpMV
SPMV_KERNELS = ("stencil_nd_kernel", "stencil7_dot_kernel")


def spmv_bytes(points: int, n_fields: int, itemsize: int) -> int:
    reads_input = points
    reads_fields = n_fields * points
    writes_output = points
    return (reads_input + reads_fields + writes_output) * itemsize


def read(run):
    peak = hbm_bytes_per_s(run.device_kind)
    if run.stretch is None or peak is None:
        return None
    spmvs = [k for k in run.stretch.kernels if k.base in SPMV_KERNELS]
    seconds = sum(k.seconds for k in spmvs)
    if not spmvs or seconds <= 0:
        return None
    f = run.facts
    moved = len(spmvs) * spmv_bytes(f["points"], f["n_fields"], f["itemsize"])
    return moved / peak / seconds * 100.0
