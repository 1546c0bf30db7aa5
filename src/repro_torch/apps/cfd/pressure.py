"""Pressure-correction (continuity) system of SIMPLE (paper §VI Alg. 2).

Counterpart of ``repro/apps/cfd/pressure.py``.  The p' equation couples
cells through the momentum ``d = h/aP`` face coefficients; boundary faces
(walls, channel inlet where the velocity is prescribed, zero-gradient
outlet) carry ``d = 0`` — they are excluded from the correction, which the
momentum layer already encodes by zeroing ``d`` on its identity rows.  The
pure-Neumann system is singular, so one reference cell is pinned.
"""

from __future__ import annotations

import torch

from repro_torch.apps.cfd.grid import CFDConfig
from repro_torch.apps.cfd.momentum import window


def divergence(cfg: CFDConfig, u_star, v_star, usp, vsp, gi):
    """Cell continuity defect of the starred field, ``(∂u + ∂v) · h``.

    ``usp``/``vsp`` are the halo-padded starred fields (west/south neighbor
    faces).  At a channel inlet the west face is the prescribed ``u_in``
    rather than the zero the wall halo provides.
    """
    h = 1.0 / cfg.n
    div = (u_star - window(usp, -1, 0) + v_star - window(vsp, 0, -1)) * h
    if cfg.scenario == "channel":
        div = div - torch.where(gi == 0, h * cfg.u_in, 0.0)
    return div


def form_pressure_system(cfg: CFDConfig, du, dv, dup, dvp, div, gi, gj):
    """p'-equation rows: ``aE = dE·h`` at interior faces, 0 at boundaries.

    Returns ``(aP, aE, aW, aN, aS, b)``; the reference cell (0, 0) is pinned
    to lift the Neumann singularity.
    """
    h = 1.0 / cfg.n
    aE = du * h
    aW = window(dup, -1, 0) * h
    aN = dv * h
    aS = window(dvp, 0, -1) * h
    aP = aE + aW + aN + aS
    aP = aP + torch.where((gi == 0) & (gj == 0), 1.0, 0.0)
    return aP, aE, aW, aN, aS, -div
