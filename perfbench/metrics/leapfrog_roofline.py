"""K7's share of its HBM roofline, in per cent: the compulsory bytes of the
leapfrog launches in the traced stretch, at the card's published HBM
bandwidth (3.35 TB/s on an H100; :mod:`perfbench.peaks`), over the device
time of those launches.  Layer: the kernels (``kernels/wave``, K7,
``csrc/wave_leapfrog.cu``).

Compulsory bytes of one step on ``N`` points, in float32 words: read
``u^n``, ``u^{n-1}`` and ``c`` once, write ``u^{n+1}`` once: ``4 N``
(16 B a point).  Not counted: the halo planes and rows a tile re-reads.
"""

from perfbench.peaks import hbm_bytes_per_s

UNIT = "%"
LAYER = "kernels"
MOVES = "ms_per_iter"
#: the device function of one leapfrog step, one launch a step
LEAPFROG_KERNELS = ("wave_leapfrog_kernel",)
#: float32 words a point a step: u^n, u^{n-1} and c read, u^{n+1} written
WORDS_PER_POINT = 4


def step_bytes(points: int, itemsize: int = 4) -> int:
    return WORDS_PER_POINT * points * itemsize


def read(run):
    peak = hbm_bytes_per_s(run.device_kind)
    if run.stretch is None or peak is None:
        return None
    steps = [k for k in run.stretch.kernels if k.base in LEAPFROG_KERNELS]
    seconds = sum(k.seconds for k in steps)
    if not steps or seconds <= 0:
        return None
    moved = len(steps) * step_bytes(run.facts["points"], run.facts["itemsize"])
    return moved / peak / seconds * 100.0
