"""The whole time step's share of its HBM roofline, in per cent: a step's
compulsory bytes (``leapfrog_roofline.step_bytes``: 16 B a point) at the
card's published HBM bandwidth, over the host time per step of the traced
stretch (whole shots, each shot's set-up and its wait at the end included).
Layer: the time-step loop (``core/wave.propagate_shot``).  It drops where a
copy, a second launch or a host wait creeps into the step while K7 itself
stays fast (``leapfrog_roofline``)."""

from perfbench.metrics.leapfrog_roofline import step_bytes
from perfbench.peaks import hbm_bytes_per_s

UNIT = "%"
LAYER = "time-step loop"
MOVES = "ms_per_iter"


def read(run):
    peak = hbm_bytes_per_s(run.device_kind)
    if run.stretch is None or peak is None or not run.stretch_iterations:
        return None
    per_step_s = run.stretch.window_s / run.stretch_iterations
    return step_bytes(run.facts["points"], run.facts["itemsize"]) / peak / per_step_s * 100.0
