"""The whole iteration's share of its HBM roofline, in per cent: the
iteration's compulsory bytes at the card's published HBM bandwidth (3.35
TB/s on an H100; :mod:`perfbench.peaks`), over the host time per iteration
of the traced stretch (whole solves, each solve's set-up included).
Layer: the whole iteration.  It stands where a FLOP share would: the solve
is bound by bytes, and this share bounds any gain a later change claims
once the kernel it removed no longer shows in ``spmv_roofline``.

Compulsory bytes per iteration and point, in words of the storage dtype, for
``F`` stored coefficient fields.  A global reduction splits the iteration
into sweeps over memory; each sweep reads what it needs once and writes what
it produces once, the inner products ride on the sweeps, each SpMV reads the
fields once, and vectors formed from others in the same sweep are never
stored.

``bicgstab`` (3 reductions, so 3 sweeps):

* sweep A, after ``<r0,r'>, <r',r'>``: ``p' = r + beta (p - omega s)`` on
  the fly, ``s' = A p'``, ``<r0,s'>``; reads r, p, s, r0 (4) and the fields
  (F); writes p', s' (2);
* sweep B, after ``<r0,s'>``: ``q = r - alpha s'`` on the fly, ``y = A q``,
  ``<q,y>, <y,y>``; reads r, s' (2) and the fields (F); writes y (1);
* sweep C, after ``<q,y>, <y,y>``: ``x' = x + alpha p' + omega q``, ``r' =
  q - omega y``, ``<r0,r'>, <r',r'>``; reads x, p', r, s', y, r0 (6);
  writes x', r' (2);
* total ``2F + 17``: star7: 29 words.

Not counted: zero-padded copies, a separately stored SpMV input ``q``, the
per-solve cast of the fields, and any re-read a kernel split adds.
"""

from perfbench.peaks import hbm_bytes_per_s

UNIT = "%"
LAYER = "whole iteration"
MOVES = "ms_per_iter"

#: per solver: the sweeps of one iteration as (vector reads, field reads, vector writes),
#: fields in units of F
SWEEPS = {
    "bicgstab": ((4, 1, 2), (2, 1, 1), (6, 0, 2)),
}


def iteration_bytes(solver: str, points: int, n_fields: int, itemsize: int) -> int:
    words = sum(vr + fr * n_fields + vw for vr, fr, vw in SWEEPS[solver])
    return words * points * itemsize


def read(run):
    peak = hbm_bytes_per_s(run.device_kind)
    f = run.facts
    if (run.stretch is None or peak is None or not run.stretch_iterations
            or f["solver"] not in SWEEPS):
        return None
    per_iter_s = run.stretch.window_s / run.stretch_iterations
    moved = iteration_bytes(f["solver"], f["points"], f["n_fields"], f["itemsize"])
    return moved / peak / per_iter_s * 100.0
