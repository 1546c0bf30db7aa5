"""The batched SpMV's share of its HBM roofline, in per cent: the compulsory
bytes of the stencil launches in the traced stretch, each serving a block of
B right-hand sides, at the card's published HBM bandwidth (3.35 TB/s on an
H100; :mod:`perfbench.peaks`), over the device time of those launches.
Layer: the kernels (``kernels/stencil_nd``, K1b).

Compulsory bytes of one launch on ``N`` points a right-hand side with ``F``
stored coefficient fields, in words of the storage dtype: read each field
once for the whole block (``F N``), read each right-hand side's input once
and write its output once (``2 B N``): ``(F + 2B) N``.  At B = 1 this is
``spmv_roofline.spmv_bytes``.
"""

from perfbench.peaks import hbm_bytes_per_s

UNIT = "%"
LAYER = "kernels"
MOVES = "ms_per_iter"
#: the device function of a batched SpMV, one launch for the whole block
SPMV_KERNELS = ("stencil_nd_kernel",)


def block_spmv_bytes(points: int, n_fields: int, itemsize: int, nrhs: int) -> int:
    reads_fields = n_fields * points
    reads_inputs = nrhs * points
    writes_outputs = nrhs * points
    return (reads_fields + reads_inputs + writes_outputs) * itemsize


def read(run):
    peak = hbm_bytes_per_s(run.device_kind)
    f = run.facts
    if run.stretch is None or peak is None or "nrhs" not in f:
        return None
    spmvs = [k for k in run.stretch.kernels if k.base in SPMV_KERNELS]
    seconds = sum(k.seconds for k in spmvs)
    if not spmvs or seconds <= 0:
        return None
    moved = len(spmvs) * block_spmv_bytes(f["points"], f["n_fields"], f["itemsize"], f["nrhs"])
    return moved / peak / seconds * 100.0
