"""Share of the traced stretch in which no operation ran on the device, in
per cent.  Layer: the device (H100 HBM3)."""

UNIT = "%"
LAYER = "device"
MOVES = "ms_per_iter"


def read(run):
    if run.stretch is None or run.stretch.window_s <= 0:
        return None
    return (1.0 - run.stretch.busy_s / run.stretch.window_s) * 100.0
