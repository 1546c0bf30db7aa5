"""The whole block iteration's share of its HBM roofline, in per cent: the
compulsory bytes of one iteration over a block of B right-hand sides at the
card's published HBM bandwidth (3.35 TB/s on an H100;
:mod:`perfbench.peaks`), over the host time per iteration of the traced
stretch (whole block solves, each solve's set-up included).  Layer: the
whole iteration.

The sweeps are ``iter_roofline.SWEEPS``'s: each reads its vectors and
writes its vectors once a right-hand side, and reads the fields once for
the whole block.  BiCGStab: ``2F + 17B`` words a point (star7 at B = 3:
63).  At B = 1 this is ``iter_roofline.iteration_bytes``.
"""

from perfbench.metrics.iter_roofline import SWEEPS
from perfbench.peaks import hbm_bytes_per_s

UNIT = "%"
LAYER = "whole iteration"
MOVES = "ms_per_iter"


def block_iteration_bytes(solver: str, points: int, n_fields: int, itemsize: int,
                          nrhs: int) -> int:
    words = sum(nrhs * (vr + vw) + fr * n_fields for vr, fr, vw in SWEEPS[solver])
    return words * points * itemsize


def read(run):
    peak = hbm_bytes_per_s(run.device_kind)
    f = run.facts
    if (run.stretch is None or peak is None or not run.stretch_iterations
            or f["solver"] not in SWEEPS or "nrhs" not in f):
        return None
    per_iter_s = run.stretch.window_s / run.stretch_iterations
    moved = block_iteration_bytes(f["solver"], f["points"], f["n_fields"], f["itemsize"],
                                  f["nrhs"])
    return moved / peak / per_iter_s * 100.0
