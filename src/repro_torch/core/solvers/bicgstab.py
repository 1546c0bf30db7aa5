"""BiCGStab (paper Alg. 1, §IV), generic over a LinearOperator.

Counterpart of ``repro/core/solvers/bicgstab.py``.  Two loops share the
algorithm:

* :func:`bicgstab_loop` over ``op.apply`` and ``op.dots`` (reference and
  spmd backends);
* :func:`bicgstab_fused_loop` over the operator's fused kernels
  (``op.fused``): per iteration 2 SpMV kernels, the fused update+dot passes
  emitting f32 local partials, and exactly three ``op.reduce_partials``
  sync points.

    s = A p;                <r0, s>                      (sync point 1)
    y = A q;                <q, y>, <y, y>               (sync point 2)
    r+ = q - w y;           <r0, r+>, <r+, r+>           (sync point 3)

Both loops take a batch of right-hand sides ``(B, ...)``: every scalar of
the recurrence is then ``[B]``, aligned against the vectors by
``bcast_scalar``, and ``run_krylov`` freezes each RHS at its exit.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.precision import F32, Policy
from repro_torch.core.solvers.common import (
    SolveResult, axpy_family, bcast_scalar, convergence_test, finish,
    init_counters, run_krylov, safe_div,
)
from repro_torch.obs import trace as obs_trace


def bicgstab_step(apply_A: Callable, dots: Callable, policy: Policy, axpy, axpy2,
                  x, r, p, r0, rho):
    """One iteration of the generic algorithm: ``(x, r, p, rho, res2, brk)``
    from ``(x, r, p)``, the shadow residual ``r0`` and ``rho = <r0, r>``."""
    s = apply_A(p)
    (r0s,) = dots([(r0, s)], policy)
    alpha, bad1 = safe_div(rho, r0s)
    q = axpy(-alpha, s, r)
    y = apply_A(q)
    qy, yy = dots([(q, y), (y, y)], policy)
    omega, bad2 = safe_div(qy, yy)
    x = axpy2(alpha, p, omega, q, x)
    r_new = axpy(-omega, y, q)
    rho_new, res2_new = dots([(r0, r_new), (r_new, r_new)], policy)
    beta_frac, bad3 = safe_div(rho_new, rho)
    alpha_frac, bad4 = safe_div(alpha, omega)
    p = axpy(beta_frac * alpha_frac, axpy(-omega, s, p), r_new)
    return x, r_new, p, rho_new, res2_new, bad1 | bad2 | bad3 | bad4


def bicgstab_fused_step(op, policy: Policy, x, r, p, r0, rho):
    """One iteration through the operator's fused kernels, with the same
    inputs and outputs as :func:`bicgstab_step`.

    ``update_q_dots`` recomputes ``q = r - alpha*s`` in the pass that forms
    the <q,y>/<y,y> partials: the SpMV needs q before y exists.  Where the
    operator's ``apply_axpy`` takes the operands (``takes_axpy``: one rank,
    the unit diagonal, Z whole 16-B vectors, no preconditioner; one block or
    a batch), the SpMV forms q itself as it stages it, so q is never stored;
    otherwise (ranks, a preconditioner, a raw diagonal, odd Z) q is first
    formed by plain tensor ops as the SpMV input.  Both use the kernel's
    arithmetic, so y has the same bits either way.
    """
    f, st = op.fused, policy.storage
    s = op.apply(p)
    (r0s,) = op.reduce_partials([f.dot_partial(r0, s)])     # sync point 1
    alpha, bad1 = safe_div(rho, r0s)
    if op.takes_axpy(s):
        y = op.apply_axpy(alpha, r, s)
    else:
        with obs_trace.span("bicgstab.q_in"):
            q_in = r - bcast_scalar(alpha.to(st), s) * s     # SpMV input, kernel-identical
        y = op.apply(q_in)
        del q_in
    q, qy, yy = f.update_q_dots(alpha, r, s, y)
    qy, yy = op.reduce_partials([qy, yy])                   # sync point 2
    omega, bad2 = safe_div(qy, yy)
    x, r_new, r0r, rr = f.update_xr_dots(alpha, omega, x, p, q, y, r0)
    rho_new, res2_new = op.reduce_partials([r0r, rr])       # sync point 3
    beta_frac, bad3 = safe_div(rho_new, rho)
    alpha_frac, bad4 = safe_div(alpha, omega)
    p = f.update_p(beta_frac * alpha_frac, omega, r_new, p, s)
    return x, r_new, p, rho_new, res2_new, bad1 | bad2 | bad3 | bad4


def bicgstab_loop(apply_A: Callable, dots: Callable, b, x0, *, tol: float = 1e-6,
                  maxiter: int = 200, policy: Policy = F32, record_history: bool = False,
                  axpy=None, axpy2=None) -> SolveResult:
    """The generic algorithm body over bare ``apply_A``/``dots`` callables."""
    default_axpy, default_axpy2 = axpy_family(policy)
    axpy = axpy or default_axpy
    axpy2 = axpy2 or default_axpy2

    b = b.to(policy.storage)
    if x0 is None:
        x0 = torch.zeros_like(b)
        r0 = b
    else:
        x0 = x0.to(policy.storage)
        r0 = axpy(torch.tensor(-1.0, device=b.device), apply_A(x0), b)

    bnorm2, rho0 = dots([(b, b), (r0, r0)], policy)  # one setup sync point
    converged = convergence_test(tol, bnorm2)

    def step(carry):
        i, x, r, p, rho, res2, conv, brk = carry
        x, r, p, rho, res2, brk = bicgstab_step(apply_A, dots, policy, axpy, axpy2,
                                                x, r, p, r0, rho)
        return i + 1, x, r, p, rho, res2, converged(res2), brk

    conv0 = converged(rho0)
    i0, brk0 = init_counters(conv0)
    init = (i0, x0, r0, r0, rho0, rho0, conv0, brk0)
    final, hist = run_krylov(step, init, maxiter=maxiter, bnorm2=bnorm2,
                             record_history=record_history)
    return finish(final, bnorm2, history=hist)


def bicgstab_fused_loop(op, b, x0, *, tol: float = 1e-6, maxiter: int = 200,
                        policy: Policy = F32, record_history: bool = False) -> SolveResult:
    """BiCGStab through the operator's fused kernels (``op.fused``), one
    :func:`bicgstab_fused_step` per iteration."""
    f = op.fused
    if f is None:
        raise ValueError("operator has no fused kernels (use bicgstab_loop)")
    st = policy.storage

    with obs_trace.span("krylov.init"):
        b = b.to(st)
        if x0 is None:
            x0 = torch.zeros_like(b)
            r0 = b
        else:
            x0 = x0.to(st)
            r0 = (b.to(policy.compute) - op.apply(x0).to(policy.compute)).to(st)

        bnorm2, rho0 = op.reduce_partials([f.dot_partial(b, b), f.dot_partial(r0, r0)])
        converged = convergence_test(tol, bnorm2)
        conv0 = converged(rho0)
        i0, brk0 = init_counters(conv0)
        init = (i0, x0, r0, r0, rho0, rho0, conv0, brk0)

    def step(carry):
        i, x, r, p, rho, res2, conv, brk = carry
        x, r, p, rho, res2, brk = bicgstab_fused_step(op, policy, x, r, p, r0, rho)
        return i + 1, x, r, p, rho, res2, converged(res2), brk

    final, hist = run_krylov(step, init, maxiter=maxiter, bnorm2=bnorm2,
                             record_history=record_history)
    return finish(final, bnorm2, history=hist)


def bicgstab_solver(op, b, x0=None, *, tol: float = 1e-6, maxiter: int = 200,
                    policy: Policy = F32, record_history: bool = False,
                    precond=None) -> SolveResult:
    """Registry entry point: BiCGStab over a LinearOperator, right
    preconditioned; takes the fused loop when the operator has kernels."""
    from repro_torch.core.precond import warm_start, wrap_right

    wrapped, unwrap = wrap_right(op, precond)
    x0 = warm_start(precond, x0)
    if wrapped.fused is not None:
        res = bicgstab_fused_loop(wrapped, b, x0, tol=tol, maxiter=maxiter, policy=policy,
                                  record_history=record_history)
    else:
        res = bicgstab_loop(wrapped.apply, wrapped.dots, b, x0, tol=tol, maxiter=maxiter,
                            policy=policy, record_history=record_history)
    return unwrap(res)
