"""Conjugate gradients, generic over a LinearOperator.

Counterpart of ``repro/core/solvers/cg.py``.  Per iteration, 2 sync points
against BiCGStab's 3:

    ap = A p;        <p, ap>              (sync point 1)
    r+ = r - a*ap;   <r+, r+>             (sync point 2)

Breakdown is flagged when <p, Ap> vanishes (e.g. CG on a nonsymmetric
stencil) or the rho recurrence degenerates.  A batch of right-hand sides
carries ``[B]`` scalars, as the BiCGStab loops do.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.precision import F32, Policy
from repro_torch.core.solvers.common import (
    SolveResult, axpy_family, convergence_test, finish, init_counters, run_krylov, safe_div,
)


def cg_loop(apply_A: Callable, dots: Callable, b, x0=None, *, tol: float = 1e-6,
            maxiter: int = 200, policy: Policy = F32,
            record_history: bool = False) -> SolveResult:
    """The algorithm body over bare ``apply_A``/``dots`` callables."""
    axpy, _ = axpy_family(policy)
    b = b.to(policy.storage)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0.to(policy.storage)
        r = axpy(torch.tensor(-1.0, device=b.device), apply_A(x), b)
    bnorm2, rho0 = dots([(b, b), (r, r)], policy)   # one setup sync point
    converged = convergence_test(tol, bnorm2)

    def step(carry):
        i, x, r, p, rho, conv, brk = carry
        ap = apply_A(p)
        (pap,) = dots([(p, ap)], policy)
        alpha, bad1 = safe_div(rho, pap)
        x = axpy(alpha, p, x)
        r = axpy(-alpha, ap, r)
        (rho_new,) = dots([(r, r)], policy)
        beta, bad2 = safe_div(rho_new, rho)
        p = axpy(beta, p, r)
        return i + 1, x, r, p, rho_new, converged(rho_new), brk | bad1 | bad2

    conv0 = converged(rho0)
    i0, brk0 = init_counters(conv0)
    init = (i0, x, r, r, rho0, conv0, brk0)
    final, hist = run_krylov(step, init, maxiter=maxiter, bnorm2=bnorm2,
                             record_history=record_history)
    return finish(final, bnorm2, history=hist)


def cg_solver(op, b, x0=None, *, tol: float = 1e-6, maxiter: int = 200,
              policy: Policy = F32, record_history: bool = False,
              precond=None) -> SolveResult:
    """Registry entry point: CG over a LinearOperator, right preconditioned.

    CG's theory wants A SPD and M^-1 symmetric in the A inner product:
    Chebyshev (a polynomial in A) keeps that, Jacobi only with a constant
    diagonal.
    """
    from repro_torch.core.precond import warm_start, wrap_right

    wrapped, unwrap = wrap_right(op, precond)
    res = cg_loop(wrapped.apply, wrapped.dots, b, warm_start(precond, x0), tol=tol,
                  maxiter=maxiter, policy=policy, record_history=record_history)
    return unwrap(res)
