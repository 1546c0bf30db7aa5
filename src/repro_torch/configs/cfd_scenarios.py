"""Named CFD application cells (paper §VI: the MFIX-class workload).

Counterpart of ``repro/configs/cfd_scenarios.py``, with the same cells: a
cell fixes the scenario, grid, physics, and which registry entries
(solver/backend/precond) the inner solves route through, so benchmarks and
tests can name a workload instead of re-assembling flags.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CFDCell:
    name: str
    scenario: str                   # "cavity" | "channel"
    n: int
    reynolds: float
    solver: str = "bicgstab"
    backend: str = "spmd"
    precond: str = "none"
    policy: str = "f32"
    normalize: bool = True          # False => raw aP rows (jacobi is real work)
    dt: float | None = None         # None => steady
    n_steps: int = 0                # transient steps when dt is set
    schedule: str = "overlap"       # halo schedule (core.comm.SCHEDULES)
    p_solver: str | None = None     # pressure-solve override (default: solver)


CFD_CELLS = {
    # the Ghia et al. validation flow (paper Figs. 7-8 run this cavity);
    # unit-diagonal rows (the paper's scheme) — jacobi is the identity here,
    # cavity_raw_jacobi below is where the preconditioner does real work
    "cavity_ghia": CFDCell("cavity_ghia", "cavity", n=32, reynolds=100.0),
    # raw-row variant: the registry Jacobi does the paper's normalization
    "cavity_raw_jacobi": CFDCell("cavity_raw_jacobi", "cavity", n=32,
                                 reynolds=100.0, precond="jacobi",
                                 normalize=False),
    # impulsively-started transient cavity (checkpointed spin-up)
    "cavity_spinup": CFDCell("cavity_spinup", "cavity", n=32, reynolds=100.0,
                             dt=0.05, n_steps=100),
    # inflow/outflow channel toward the developed profile
    "channel_develop": CFDCell("channel_develop", "channel", n=24,
                               reynolds=50.0, dt=0.05, n_steps=80),
    # communication-lean cavity: overlapped halos in every inner SpMV and
    # the single-AllReduce pipelined solver on the (iteration-dominant)
    # pressure-correction system
    "cavity_pipelined": CFDCell("cavity_pipelined", "cavity", n=32,
                                reynolds=100.0, schedule="overlap",
                                p_solver="pipelined_bicgstab"),
    "smoke": CFDCell("smoke", "cavity", n=12, reynolds=100.0),
}


def build(cell: CFDCell):
    """Instantiate (CFDConfig, SolverOptions, TransientConfig|None)."""
    from repro_torch.apps.cfd import CFDConfig, SolverOptions, TransientConfig
    from repro_torch.core.precision import get_policy

    cfg = CFDConfig(n=cell.n, reynolds=cell.reynolds, scenario=cell.scenario,
                    policy=get_policy(cell.policy))
    opts = SolverOptions(solver=cell.solver, backend=cell.backend,
                         precond=cell.precond, normalize=cell.normalize,
                         schedule=cell.schedule, p_solver=cell.p_solver)
    tcfg = (TransientConfig(dt=cell.dt, n_steps=cell.n_steps)
            if cell.dt is not None else None)
    return cfg, opts, tcfg
