"""Published peaks of the cards a run may report, by the name that
``torch.cuda.get_device_name()`` gives: NVIDIA's H100 data sheet (SXM, at
the full 700 W power limit), 3.35 TB/s of HBM3.  The solves are bound by
bytes, so the rooflines read this figure alone.

A card missing here has no roofline: its roofline metrics stay silent.
"""

from __future__ import annotations

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(kind: str) -> float | None:
    return HBM_BYTES_PER_S.get(kind)
