"""Legacy import surface for the SIMPLE CFD solver (seed API).

Counterpart of ``repro/core/simple_cfd.py``: the implementation lives in
:mod:`repro_torch.apps.cfd`, whose inner solves run through the operator/
solver/preconditioner registries; the historical names keep working.

``simple_step`` / ``solve_cavity`` keep the seed's staggered-array
signatures; new code should import from ``repro_torch.apps.cfd`` and use the
cell-shaped state + ``SolverOptions`` directly.
"""

from __future__ import annotations

from repro_torch.apps.cfd import (  # noqa: F401
    CavityConfig, CFDConfig, SolverOptions, centerline_u, simple_step,
    solve_cavity, solve_steady,
)

__all__ = [
    "CavityConfig", "CFDConfig", "SolverOptions", "centerline_u",
    "simple_step", "solve_cavity", "solve_steady",
]
