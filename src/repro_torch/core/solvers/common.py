"""Shared solver plumbing: SolveResult, safe division, the AXPY family, and
the host loop every Krylov solver runs.

Counterpart of ``repro/core/solvers/common.py``.  The JAX package runs its
loops as ``lax.while_loop``/``lax.scan`` inside jit; here :func:`run_krylov`
is a host loop over eager tensors.  Every scalar of the recurrence stays a
0-d tensor on the device, so the loop's only wait on the card is one flag,
``conv | brk``, read once per iteration.

The many-RHS batch axis (per-RHS freeze masks) is the next slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.precision import Policy


@dataclasses.dataclass
class SolveResult:
    """Uniform solver output."""

    x: torch.Tensor
    iterations: torch.Tensor          # int32 0-d
    rel_residual: torch.Tensor        # recurrence residual at exit
    converged: torch.Tensor           # bool 0-d
    breakdown: torch.Tensor           # bool 0-d: a recurrence denominator vanished
    history: torch.Tensor | None = None  # f32[maxiter] relative residuals


EPS = 1e-30


def convergence_test(tol: float, bnorm2: torch.Tensor):
    """The relative-residual predicate ``res2 <= tol^2 * ||b||^2``, with the
    threshold computed in ``bnorm2``'s dtype."""
    t = torch.tensor(tol, dtype=bnorm2.dtype, device=bnorm2.device)
    thresh = t * t * bnorm2

    def converged(res2):
        return res2 <= thresh

    return converged


def safe_div(num: torch.Tensor, den: torch.Tensor):
    """num/den plus a breakdown flag when the denominator vanished."""
    ok = den.abs() > EPS
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num)), ~ok


def bcast_scalar(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-RHS scalar (``[B]`` or 0-d) aligned against ``x`` for broadcast."""
    if a.ndim == 0 or a.ndim >= x.ndim:
        return a
    return a.reshape(tuple(a.shape) + (1,) * (x.ndim - a.ndim))


def axpy_family(policy: Policy):
    """AXPY family in compute precision (paper Table I: 6 HP AXPYs/iter)."""
    c = policy.compute

    def axpy(a, x, y):  # y + a*x
        ac = bcast_scalar(torch.as_tensor(a, device=x.device).to(c), x)
        return (y.to(c) + ac * x.to(c)).to(policy.storage)

    def axpy2(a, x, b, y, z):  # z + a*x + b*y
        ac = bcast_scalar(torch.as_tensor(a, device=x.device).to(c), x)
        bc = bcast_scalar(torch.as_tensor(b, device=y.device).to(c), y)
        return (z.to(c) + ac * x.to(c) + bc * y.to(c)).to(policy.storage)

    return axpy, axpy2


def local_partial(a, b, policy: Policy):
    """One FMAC-style local inner-product partial."""
    return policy.dot(a, b)


def local_dots(pairs, policy: Policy) -> torch.Tensor:
    """Single-address-space reduction: a stack of FMAC-style inner products."""
    return torch.stack([local_partial(a, b, policy) for a, b in pairs])


def init_counters(conv0: torch.Tensor):
    """(iteration counter, breakdown flag) for the carry."""
    return 0, torch.zeros_like(conv0)


def run_krylov(step, init, *, maxiter: int, bnorm2: torch.Tensor, record_history: bool):
    """Drive a Krylov ``step`` to convergence on the host.

    ``step(carry) -> carry`` advances one iteration; the carry contract is
    ``(i, x, *state, res2, conv, brk)`` with ``i`` a host int and the last
    three 0-d device tensors.  The loop stops at ``maxiter``, convergence or
    breakdown, reading ``conv | brk`` once per iteration (its only sync).

    ``record_history`` returns the f32[maxiter] relative residual after each
    iteration; iterations after the exit repeat the exit value, as the JAX
    package's fixed-length frozen scan does.
    """
    rel = lambda c: torch.sqrt(c[-3] / torch.clamp(bnorm2, min=EPS))
    carry = init
    hist = []
    while carry[0] < maxiter and not bool(carry[-2] | carry[-1]):
        carry = step(carry)
        if record_history:
            hist.append(rel(carry))
    if not record_history:
        return carry, None
    hist += [rel(carry)] * (maxiter - len(hist))      # the frozen tail
    if not hist:
        return carry, torch.zeros(0, dtype=torch.float32, device=bnorm2.device)
    return carry, torch.stack(hist).to(torch.float32)


def finish(carry, bnorm2: torch.Tensor, history=None) -> SolveResult:
    """Assemble a SolveResult from a run_krylov final carry."""
    i, x, *_rest, res2, conv, brk = carry
    rel = torch.sqrt(res2 / torch.clamp(bnorm2, min=EPS))
    return SolveResult(x, torch.tensor(i, dtype=torch.int32), rel, conv, brk, history=history)
