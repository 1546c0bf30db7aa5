"""Solve entry points: wire the rank mesh, operator backend, preconditioner and solver.

Counterpart of ``repro/core/bicgstab.py``:

* :func:`solve_ref`: single-address-space solve (the oracle; with
  ``backend="fused"`` the same solve through the kernels);
* :func:`solve_distributed`: the paper's run, every rank executing the whole
  Krylov iteration on its block.  This slice runs it on the one-rank fabric;
  a mesh with more ranks raises until the ``torch.distributed`` slice lands.
"""

from __future__ import annotations

import torch

from repro_torch.core.comm import get_schedule
from repro_torch.core.halo import FabricAxes
from repro_torch.core.operator import make_operator
from repro_torch.core.precision import F32, MIXED, Policy
from repro_torch.core.precond import PrecondConfig, build_precond, get_precond_config
from repro_torch.core.solvers import get_solver
from repro_torch.core.solvers.common import SolveResult
from repro_torch.core.stencil import StencilCoeffs


def solve_ref(coeffs: StencilCoeffs, b: torch.Tensor, x0: torch.Tensor | None = None, *,
              tol: float = 1e-6, maxiter: int = 200, policy: Policy = F32,
              record_history: bool = False, solver: str = "bicgstab",
              backend: str = "reference", precond: str | PrecondConfig | None = None,
              schedule: str | None = None) -> SolveResult:
    """Single-address-space solve; ``backend="fused"`` runs it through the
    kernels on a 1x1 fabric (every collective degenerate)."""
    op = make_operator(backend, coeffs, policy=policy, schedule=schedule)
    M = build_precond(get_precond_config(precond), op)
    return get_solver(solver)(op, b, x0, tol=tol, maxiter=maxiter, policy=policy,
                              record_history=record_history, precond=M)


def solve_distributed(mesh, coeffs: StencilCoeffs, b: torch.Tensor,
                      x0: torch.Tensor | None = None, *, tol: float = 1e-6,
                      maxiter: int = 200, policy: Policy = MIXED,
                      fused_reductions: bool = True, schedule: str | None = None, record_history: bool = False,
                      solver: str = "bicgstab", backend: str = "spmd",
                      precond: str | PrecondConfig | None = None) -> SolveResult:
    """A Krylov solve with the whole iteration on every rank of ``mesh``.

    ``schedule`` ("blocking" | "overlap") picks the halo schedule.
    ``fused_reductions=False`` is the paper's one AllReduce per dot.

    ``x0=None`` starts from zero without an SpMV.  The JAX package's
    ``solve_distributed`` passes a zero warm start instead and forms
    ``r0 = b - A 0``, which is ``b`` bit for bit, so the solve is the same
    with one kernel launch less.
    """
    sched = get_schedule(schedule)
    fabric = FabricAxes.from_mesh(mesh)
    if fabric.size > 1:
        raise NotImplementedError("multi-rank solve (torch.distributed): next slice")
    if b.ndim != coeffs.ndim:
        raise NotImplementedError("many-RHS (batched) solves: next slice")
    cf = coeffs.astype(policy.storage)
    op = make_operator(backend, cf, fabric, policy=policy, schedule=sched,
                       fused_reductions=fused_reductions)
    M = build_precond(get_precond_config(precond), op)
    return get_solver(solver)(op, b, x0, tol=tol, maxiter=maxiter, policy=policy,
                              record_history=record_history, precond=M)
