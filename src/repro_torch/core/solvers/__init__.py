"""Solver registry: Krylov loops generic over a LinearOperator.

Counterpart of ``repro/core/solvers/__init__.py``.  Every solver is
``(operator, b, x0, *, tol, maxiter, policy, record_history, precond) ->
SolveResult``.  This slice ports BiCGStab; CG and the pipelined solvers come
later.
"""

from __future__ import annotations

from repro_torch.core.solvers.bicgstab import bicgstab_solver

SOLVERS = {
    "bicgstab": bicgstab_solver,
}


def get_solver(name: str):
    try:
        return SOLVERS[name]
    except KeyError:
        raise KeyError(f"unknown solver {name!r}; have {sorted(SOLVERS)}") from None
