"""Shared solver plumbing: SolveResult, safe division, the AXPY family, and
the host loop every Krylov solver runs.

Counterpart of ``repro/core/solvers/common.py``.  The JAX package runs its
loops as ``lax.while_loop``/``lax.scan`` inside jit; here :func:`run_krylov`
is a host loop over eager tensors.  Every scalar of the recurrence stays a
tensor on the device, so the loop's only wait on the card is one read per
iteration: the flag ``conv | brk``, or for a batch the ``[B]`` active mask.

Batched (many-RHS) solves carry per-RHS scalars (``[B]`` alpha, rho,
res2, convergence and breakdown masks, an int32[B] iteration counter), and
:func:`run_krylov` freezes each RHS at its exit state while the others
iterate on, so per-RHS iteration counts are exact.  A ``B = 1`` batch is the
unbatched solve bit for bit: the same ops run on a leading axis of extent 1.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.precision import Policy
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import record_solve


@dataclasses.dataclass
class SolveResult:
    """Uniform solver output."""

    x: torch.Tensor
    iterations: torch.Tensor          # int32 0-d (int32[B] for a batched solve)
    rel_residual: torch.Tensor        # recurrence residual at exit ([B])
    converged: torch.Tensor           # bool 0-d ([B]): independent per-RHS masks
    breakdown: torch.Tensor           # bool 0-d ([B]): a recurrence denominator vanished
    history: torch.Tensor | None = None  # f32[maxiter(, B)] relative residuals


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


def local_partial(a, b, policy: Policy, *, mesh_ndim: int | None = None):
    """One FMAC-style local inner-product partial, batch-aware.

    With ``mesh_ndim`` given, operands whose rank exceeds it carry a leading
    batch axis: each RHS slice gets its own ``policy.dot`` (the unbatched
    summation order, so ``B = 1`` is bitwise the unbatched dot; one sum over
    a ``(B, n)`` axis would sum in another order) and the partial is a
    ``[B]`` row.
    """
    nb = 0 if mesh_ndim is None else a.ndim - mesh_ndim
    if nb <= 0:
        return policy.dot(a, b)
    return torch.stack([policy.dot(a[i], b[i]) for i in range(a.shape[0])])


def local_dots(pairs, policy: Policy, *, mesh_ndim: int | None = None) -> torch.Tensor:
    """Single-address-space reduction: a stack of FMAC-style inner products
    (``[k]``, or ``[k, B]`` for batched operands)."""
    return torch.stack([local_partial(a, b, policy, mesh_ndim=mesh_ndim) for a, b in pairs])


def init_counters(conv0: torch.Tensor):
    """(iteration counter, breakdown flag) for the carry: a host int and a 0-d
    flag, or per RHS an int32[B] counter and a bool[B] flag on the device."""
    if conv0.ndim == 0:
        return 0, torch.zeros_like(conv0)
    return torch.zeros(conv0.shape, dtype=torch.int32, device=conv0.device), \
        torch.zeros_like(conv0)


def _freeze_select(mask: torch.Tensor, new, old):
    """``where(mask, new, old)`` with a ``bool[B]`` mask broadcast from the
    leading (batch) axis, for ``(B, ...)`` vectors and ``[B]`` scalars alike."""
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)


def _stop_flags(carry, batched: bool):
    """``(stop, active, all_active)`` from the carry's flags: the loop's one
    wait on the card, in a ``krylov.flag_wait`` span.  ``active`` is the
    device's ``[B]`` mask of a batched carry (None unbatched)."""
    stopped = carry[-2] | carry[-1]
    if not batched:
        with obs_trace.span("krylov.flag_wait"):
            return bool(stopped), None, True
    active = ~stopped
    with obs_trace.span("krylov.flag_wait"):
        act = active.cpu()
    return not bool(act.any()), active, bool(act.all())


def run_krylov(step, init, *, maxiter: int, bnorm2: torch.Tensor, record_history: bool):
    """Drive a Krylov ``step`` to convergence on the host.

    ``step(carry) -> carry`` advances one iteration; the carry contract is
    ``(i, x, *state, res2, conv, brk)``, the last three on the device.  The
    loop stops at ``maxiter``, convergence or breakdown, reading ``conv |
    brk`` once per iteration (its only sync): before the first step, then
    after each step but the ``maxiter``-th.  Each iteration is a
    ``krylov.iteration`` span that enqueues its step and then waits for its
    flag (``krylov.flag_wait``); the first also holds the read before the
    first step (and, in a solve that stops before it, nothing else).

    A batched carry (``[B]`` flags) runs while any RHS is active, reading
    the ``[B]`` active mask once per iteration.  An RHS that has stopped
    keeps its exit state: the step's result is merged back per RHS with
    ``where(active, new, old)``, but only in iterations that the mask shows
    a stopped RHS in.  With every RHS active the merge would return ``new``
    bit for bit, and would read and write every vector of the state once
    more.  The counter ``krylov.freeze_merges`` counts the iterations that
    ran the merge, added once a solve from the loop's own tally.

    ``record_history`` returns the f32[maxiter(, B)] relative residual after
    each iteration; iterations after an RHS's exit repeat its exit value, as
    the JAX package's fixed-length frozen scan does.
    """
    rel = lambda c: torch.sqrt(c[-3] / torch.clamp(bnorm2, min=EPS))
    batched = init[-2].ndim > 0
    carry = init
    hist = []
    n = 0
    merges = 0
    stop = maxiter <= 0
    while not stop:
        with obs_trace.span("krylov.iteration"):
            if n == 0:
                stop, active, all_active = _stop_flags(carry, batched)
                if stop:
                    break
            new = step(carry)
            carry = new if all_active else tuple(
                _freeze_select(active, a, b) for a, b in zip(new, carry))
            merges += not all_active
            n += 1
            if record_history:
                hist.append(rel(carry))
            stop = n >= maxiter
            if not stop:
                stop, active, all_active = _stop_flags(carry, batched)
    obs_metrics.counter("krylov.freeze_merges").inc(merges)
    if not record_history:
        return carry, None
    hist += [rel(carry)] * (maxiter - len(hist))      # the frozen tail
    if not hist:
        return carry, torch.zeros((0,) + tuple(bnorm2.shape), dtype=torch.float32,
                                  device=bnorm2.device)
    return carry, torch.stack(hist).to(torch.float32)


def finish(carry, bnorm2: torch.Tensor, history=None) -> SolveResult:
    """Assemble a SolveResult from a run_krylov final carry."""
    i, x, *_rest, res2, conv, brk = carry
    rel = torch.sqrt(res2 / torch.clamp(bnorm2, min=EPS))
    its = i.to(torch.int32) if isinstance(i, torch.Tensor) else torch.tensor(i, dtype=torch.int32)
    return SolveResult(x, its, rel, conv, brk, history=history)


#: per-solve emission (iterations, per-RHS convergence, residual history)
#: into the obs registry, under the JAX package's name; ``history[k]`` is
#: the relative residual after iteration k+1 for every solver
emit_solve_metrics = record_solve
