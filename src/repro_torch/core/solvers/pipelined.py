"""Pipelined Krylov solvers: one sync point per iteration.

Counterpart of ``repro/core/solvers/pipelined.py``.  The generic loops
reduce at every recurrence dependency (BiCGStab 3 times per iteration, CG
twice); these reformulations form every inner product of an iteration from
vectors already in hand and reduce them at one sync point:

* :func:`pipelined_cg_loop`: Ghysels & Vanroose's pipelined CG.  Its two
  dots (<r,r>, <w,r>) do not depend on the iteration's SpMV ``q = A w``.
* :func:`pipelined_bicgstab_loop`: single-reduction BiCGStab.  The alpha-
  and omega-chained dots are expanded through ``q = r - alpha s`` and
  ``y = z - alpha t`` (``z = A r`` and ``t = A s`` carried at no extra
  SpMV), so all 12 scalars of an iteration reduce together.  ``rho =
  <r0, r>`` and the norm ``<r, r>`` are fresh dots on the carried residual
  each iteration (re-anchored), so rounding drift cannot accumulate.

Both test convergence on the carried residual norm, whose update is reduced
only in the next iteration, so they report one iteration more than their
generic counterparts.  :func:`_align_history` shifts the recorded lag-1
history back so that ``history[k]`` is the relative residual after
iteration k+1 for every solver.  Pipelined CG keeps ``w = A r`` by
recurrence alone, which bounds its f32 accuracy near 1e-5.

Unbatched, the step counter ``i`` is a host int; batched, it is an
``int32[B]`` tensor, and the first-step masks are ``torch.where`` on the
device (no host read).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.precision import F32, Policy
from repro_torch.core.solvers.common import (
    SolveResult, axpy_family, convergence_test, finish, init_counters, run_krylov, safe_div,
)


def _align_history(hist):
    """Shift the lag-1 recorded history into the generic solvers' meaning:
    drop the leading entry (``||r0||``) and repeat the last reduced norm.
    A batched history (``[maxiter, B]``) shifts along the iteration axis."""
    if hist is None:
        return None
    return torch.cat([hist[1:], hist[-1:]], dim=0)


def _after_first(first, v: torch.Tensor) -> torch.Tensor:
    """``v`` where the step is not the first, zero (or False) where it is;
    ``first`` is a host bool (unbatched) or a ``bool[B]`` tensor."""
    if isinstance(first, bool):
        return torch.zeros_like(v) if first else v
    return torch.where(first, torch.zeros_like(v), v)


def pipelined_bicgstab_loop(apply_A: Callable, dots: Callable, b, x0, *, tol: float = 1e-6,
                            maxiter: int = 200, policy: Policy = F32,
                            record_history: bool = False) -> SolveResult:
    """Single-reduction BiCGStab.

    Carried vectors: x, r, p and the SpMV images ``s = A p``, ``z = A r``,
    ``t = A s``.  Per iteration: one sync point of 12 dots, 2 SpMVs
    (``z' = A r'``, ``t' = A s'``) and 9 AXPY-class updates.
    """
    axpy, axpy2 = axpy_family(policy)
    b = b.to(policy.storage)
    if x0 is None:
        x0 = torch.zeros_like(b)
        r0 = b
    else:
        x0 = x0.to(policy.storage)
        r0 = axpy(torch.tensor(-1.0, device=b.device), apply_A(x0), b)

    # p0 = r0, so s0 = A p0 is also z0 = A r0: the setup is 2 SpMVs and one sync point
    s0 = apply_A(r0)
    t0 = apply_A(s0)
    bnorm2, rho0 = dots([(b, b), (r0, r0)], policy)
    converged = convergence_test(tol, bnorm2)

    def step(carry):
        i, x, r, p, s, z, t, res2, conv, brk = carry
        (rho, rr, r0s, r0z, r0t, rz, sz, rt, st_, zz, zt, tt) = dots(
            [(r0, r), (r, r), (r0, s), (r0, z), (r0, t), (r, z), (s, z),
             (r, t), (s, t), (z, z), (z, t), (t, t)], policy)     # the one sync point
        alpha, bad1 = safe_div(rho, r0s)
        # <q,y> and <y,y> through q = r - alpha s, y = z - alpha t
        qy = rz - alpha * (sz + rt) + alpha * alpha * st_
        yy = zz - 2.0 * alpha * zt + alpha * alpha * tt
        omega, bad2 = safe_div(qy, yy)
        # <r0,r'>, for this iteration's beta only: the next alpha re-anchors
        rho_new = (rho - alpha * r0s) - omega * (r0z - alpha * r0t)
        beta_frac, bad3 = safe_div(rho_new, rho)
        alpha_frac, bad4 = safe_div(alpha, omega)
        beta = beta_frac * alpha_frac
        q = axpy(-alpha, s, r)
        y = axpy(-alpha, t, z)
        x = axpy2(alpha, p, omega, q, x)
        r_new = axpy(-omega, y, q)
        p_new = axpy(beta, axpy(-omega, s, p), r_new)
        z_new = apply_A(r_new)
        s_new = axpy(beta, axpy(-omega, t, s), z_new)   # s' = A p' with no SpMV
        t_new = apply_A(s_new)
        conv = converged(rr)        # ||r||^2 of the carried (lag-1) residual
        brk = bad1 | bad2 | bad3 | bad4
        return i + 1, x, r_new, p_new, s_new, z_new, t_new, rr, conv, brk

    conv0 = converged(rho0)
    i0, brk0 = init_counters(conv0)
    init = (i0, x0, r0, r0, s0, s0, t0, rho0, conv0, brk0)
    final, hist = run_krylov(step, init, maxiter=maxiter, bnorm2=bnorm2,
                             record_history=record_history)
    return finish(final, bnorm2, history=_align_history(hist))


def pipelined_cg_loop(apply_A: Callable, dots: Callable, b, x0=None, *, tol: float = 1e-6,
                      maxiter: int = 200, policy: Policy = F32,
                      record_history: bool = False) -> SolveResult:
    """Ghysels-Vanroose pipelined CG: the (<r,r>, <w,r>) sync point shares
    no dependency with the iteration's one SpMV ``q = A w``.  Convergence is
    tested on the carried gamma = <r,r>, one iteration behind."""
    axpy, _ = axpy_family(policy)
    b = b.to(policy.storage)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0.to(policy.storage)
        r = axpy(torch.tensor(-1.0, device=b.device), apply_A(x), b)
    w0 = apply_A(r)
    bnorm2, gamma0 = dots([(b, b), (r, r)], policy)
    converged = convergence_test(tol, bnorm2)

    def step(carry):
        i, x, r, w, p, s, z, gamma_old, alpha_old, res2, conv, brk = carry
        gamma, delta = dots([(r, r), (w, r)], policy)    # the one sync point
        q = apply_A(w)
        first = i == 0
        beta_raw, badb = safe_div(gamma, gamma_old)
        beta = _after_first(first, beta_raw)
        corr, badc = safe_div(beta * gamma, alpha_old)
        alpha, bada = safe_div(gamma, delta - _after_first(first, corr))
        z = axpy(beta, z, q)            # z = q + beta z   (= A s)
        s = axpy(beta, s, w)            # s = w + beta s   (= A p)
        p = axpy(beta, p, r)            # p = r + beta p
        x = axpy(alpha, p, x)
        r = axpy(-alpha, s, r)
        w = axpy(-alpha, z, w)          # w = A r by recurrence
        brk = brk | bada | _after_first(first, badb | badc)
        return i + 1, x, r, w, p, s, z, gamma, alpha, gamma, converged(gamma), brk

    zeros = torch.zeros_like(b)
    conv0 = converged(gamma0)
    i0, brk0 = init_counters(conv0)
    # alpha_old shaped like gamma ([B] when batched)
    init = (i0, x, r, w0, zeros, zeros, zeros, gamma0, torch.ones_like(gamma0), gamma0,
            conv0, brk0)
    final, hist = run_krylov(step, init, maxiter=maxiter, bnorm2=bnorm2,
                             record_history=record_history)
    return finish(final, bnorm2, history=_align_history(hist))


def _right_preconditioned(loop):
    def solver(op, b, x0=None, *, tol: float = 1e-6, maxiter: int = 200,
               policy: Policy = F32, record_history: bool = False,
               precond=None) -> SolveResult:
        from repro_torch.core.precond import warm_start, wrap_right

        wrapped, unwrap = wrap_right(op, precond)
        res = loop(wrapped.apply, wrapped.dots, b, warm_start(precond, x0), tol=tol,
                   maxiter=maxiter, policy=policy, record_history=record_history)
        return unwrap(res)
    return solver


#: registry entry points, right preconditioned like the generic solvers
pipelined_bicgstab_solver = _right_preconditioned(pipelined_bicgstab_loop)
pipelined_bicgstab_solver.__name__ = "pipelined_bicgstab_solver"
pipelined_cg_solver = _right_preconditioned(pipelined_cg_loop)
pipelined_cg_solver.__name__ = "pipelined_cg_solver"
