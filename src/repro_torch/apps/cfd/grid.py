"""Staggered MAC grid bookkeeping for the SIMPLE CFD application.

Counterpart of ``repro/apps/cfd/grid.py``.  Every field is a cell-shaped
``(n, n)`` tensor, so the three linear systems of one SIMPLE iteration live
on the same mesh and split identically over a rank fabric:

* ``u[i, j]``  — x-velocity at the EAST face of cell ``(i, j)``
  (staggered face ``i+1``; the west boundary face is not stored — it is a
  known boundary value: 0 at a wall, ``u_in`` at a channel inlet);
* ``v[i, j]``  — y-velocity at the NORTH face of cell ``(i, j)``
  (staggered face ``j+1``; the south boundary face is the wall);
* ``p[i, j]``  — pressure at the cell center.

The classic ``(n+1, n)`` / ``(n, n+1)`` staggered arrays remain the public
I/O format of the legacy ``core.simple_cfd`` surface; :func:`to_staggered` /
:func:`from_staggered` convert.  With cell-shaped storage, the zero that
``gather_halo`` fills in at the fabric's edges *is* the no-slip wall value,
so boundary conditions and decomposition use one mechanism.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.precision import F32, Policy

SCENARIOS = ("cavity", "channel")


@dataclasses.dataclass
class CFDConfig:
    """SIMPLE configuration (field order keeps ``CavityConfig`` compatible).

    The inner-solve limits follow the paper: "limited to 5 iterations for
    transport [and] 20 for continuity".  ``dt=None`` is the steady SIMPLE
    loop; a finite ``dt`` adds the implicit-Euler inertial term and the
    driver marches ``outer_iters``-relaxed outer loops per time step.
    """

    n: int = 32                 # cells per side
    reynolds: float = 100.0
    lid_velocity: float = 1.0
    alpha_u: float = 0.7        # momentum under-relaxation
    alpha_p: float = 0.3        # pressure under-relaxation
    outer_iters: int = 200
    inner_tol: float = 1e-4     # paper: solver limited to a few iterations
    inner_iters_mom: int = 5    # paper: "limited to 5 iterations for transport"
    inner_iters_p: int = 20     # paper: "20 for continuity"
    tol: float = 1e-5
    policy: Policy = F32
    scenario: str = "cavity"    # "cavity" | "channel"
    u_in: float = 1.0           # channel inflow velocity
    dt: float | None = None     # None => steady; finite => transient term

    def __post_init__(self):
        if self.scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {self.scenario!r}; have {SCENARIOS}")


#: Legacy name (seed API) — same dataclass, cavity defaults.
CavityConfig = CFDConfig


def cell_state(cfg: CFDConfig, *, device: str | torch.device):
    """Zero-initialized (u, v, p) cell-shaped f32 state on ``device``."""
    z = torch.zeros((cfg.n, cfg.n), dtype=torch.float32, device=device)
    return z, z.clone(), z.clone()


def to_staggered(u: torch.Tensor, v: torch.Tensor):
    """Cell-shaped (u, v) -> classic staggered ``(n+1, n)`` / ``(n, n+1)``.

    The prepended boundary face is the homogeneous wall value; channel inlet
    faces carry ``u_in`` only inside the solver (they are boundary data, not
    state), so the staggered view shows the stored faces plus zero walls.
    """
    n = u.shape[1]
    u_stag = torch.cat([u.new_zeros((1, n)), u], dim=0)
    v_stag = torch.cat([v.new_zeros((v.shape[0], 1)), v], dim=1)
    return u_stag, v_stag


def from_staggered(u_stag: torch.Tensor, v_stag: torch.Tensor):
    """Inverse of :func:`to_staggered` (drops the known boundary faces)."""
    return u_stag[1:, :], v_stag[:, 1:]


def centerline_u(u: torch.Tensor) -> torch.Tensor:
    """u along the vertical centerline of a *staggered* field (Ghia et al.)."""
    return u[u.shape[0] // 2, :]


def global_indices(n: int, shape: tuple[int, int], ox, oy, *,
                   device: str | torch.device = "cpu"):
    """(gi, gj) global cell-index grids of a local block at offset (ox, oy).

    Broadcastable ``(bx, 1)`` / ``(1, by)`` on ``device`` — boundary masks
    (walls, inlet, outlet, reference cell) compare against these so the same
    formation code runs on any block of a split fabric (ox = oy = 0 on one
    rank).
    """
    bx, by = shape
    gi = (ox + torch.arange(bx, device=device))[:, None]
    gj = (oy + torch.arange(by, device=device))[None, :]
    return gi, gj
