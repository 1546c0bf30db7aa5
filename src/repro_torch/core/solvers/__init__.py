"""Solver registry: Krylov loops generic over a LinearOperator.

Counterpart of ``repro/core/solvers/__init__.py``.  Every solver is
``(operator, b, x0, *, tol, maxiter, policy, record_history, precond) ->
SolveResult``.  Preconditioning is applied on the right (``A M^-1 y = b,
x = M^-1 y``), so the residual, the convergence test and the sync points
are those of the unpreconditioned loop.
"""

from __future__ import annotations

from repro_torch.core.solvers.bicgstab import bicgstab_solver
from repro_torch.core.solvers.cg import cg_solver
from repro_torch.core.solvers.pipelined import pipelined_bicgstab_solver, pipelined_cg_solver

SOLVERS = {
    "bicgstab": bicgstab_solver,
    "cg": cg_solver,
    # one sync point per iteration (against 3 and 2): core/solvers/pipelined.py
    "pipelined_bicgstab": pipelined_bicgstab_solver,
    "pipelined_cg": pipelined_cg_solver,
}


def get_solver(name: str):
    try:
        return SOLVERS[name]
    except KeyError:
        raise KeyError(f"unknown solver {name!r}; have {sorted(SOLVERS)}") from None
