"""A closed stream of block solves: several right-hand sides of one stencil
operator solved together through the port's
``repro_torch.core.bicgstab.solve_distributed`` on one rank, ``b`` of shape
``(B, X, Y, Z)``.

This is the momentum predictor of a collocated finite-volume solver, whose
velocity components share one matrix (the configuration's ``nrhs`` of them).
Set-up makes the operator's float32 fields as :mod:`krylov_solve` does and a
pool of blocks, component ``c`` of block ``k`` being ``b_c = A x_c`` with
``x_c`` white noise drawn on the device from (seed, ``k``, ``c``), formed in
float32 by the reference apply one component at a time and stored in the
storage dtype.  Each step solves the next block of the pool from ``x0 = 0``
and waits for it; every solve runs the traffic's ``iterations`` Krylov
iterations (a tolerance of 0), so a step's iterations are the block's, each
serving every component.

:meth:`System.numbers` judges each component of the window's last answer
for the checked blocks against the segregated reference
(:mod:`perfbench.reference.segregated`): each component solved on its own
by the plain BiCGStab, as the source's segregated loop solves it.
:meth:`System.facts` adds ``nrhs`` and the program's counters over the
traced stretch (the steps run while the profiler records): the batched
stencil kernel's launches, the right-hand sides they served, and the
Krylov loop's per-RHS freeze merges; a counter the program lacks reads None.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from perfbench.reference import segregated
from perfbench.reference import stencil as ref_stencil
from perfbench.reference.precision import PRECISIONS
from perfbench.systems import krylov_solve
from perfbench.systems.krylov_solve import _amax, _norm2

#: the program's counters that :meth:`System.facts` reads over the traced stretch
COUNTERS = ("stencil_nd_batched_launches", "stencil_nd_batched_rhs", "freeze_merges")


def component_seed(seed: int, k: int, c: int) -> int:
    """The generator seed of component ``c`` of pool block ``k`` under the
    run's ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), k, c])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


@dataclasses.dataclass
class Answer:
    """What one block solve produced: ``x`` of shape ``(B, ...)``, and per
    component its iterations, recurrence residual and breakdown."""
    x: torch.Tensor
    iterations: list[int]
    rel_residual: list[float]
    breakdown: list[bool]


@dataclasses.dataclass
class SolveRecord:
    pool: int
    iterations: int                # the block's iterations, each serving every component
    rel_residual: float            # the largest component's recurrence residual
    failed: bool
    wall_s: float


def _program_counters() -> dict:
    """The program's counters now, None where it has no such counter."""
    from repro_torch.kernels.stencil_nd import kernel
    from repro_torch.obs import metrics

    merges = metrics.REGISTRY.counters.get("krylov.freeze_merges")
    return dict(stencil_nd_batched_launches=kernel.launches.get("stencil_nd_batched"),
                stencil_nd_batched_rhs=getattr(kernel, "rhs", {}).get("stencil_nd_batched"),
                freeze_merges=None if merges is None else merges.value)


class System(krylov_solve.System):
    """One cell's inputs and its timed call: :class:`krylov_solve.System`
    with a block of ``nrhs`` components in each pool entry.  ``wrap``
    replaces the port's solve by ``wrap(solve)`` (the tests plant faults
    with it)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, *, wrap=None):
        self.nrhs = int(config["nrhs"])
        self.stretch_counters: dict[str, int | None] = dict.fromkeys(COUNTERS, 0)
        super().__init__(config, traffic, seed, device, wrap=wrap)

    def _rhs(self, k: int) -> torch.Tensor:
        """Pool block ``k``: its components ``b_c = A x_c``, one at a time."""
        b = torch.empty((self.nrhs,) + self.shape, dtype=self.prec.compute, device=self.device)
        for c in range(self.nrhs):
            gen = torch.Generator(device=self.device).manual_seed(
                component_seed(self.seed, k, c))
            x_true = torch.randn(self.shape, generator=gen, device=self.device,
                                 dtype=torch.float32)
            b[c] = self.prec.store(ref_stencil.apply_f32(self.fields, self.offsets, x_true))
            del x_true
        return b

    def facts(self) -> dict:
        """:class:`krylov_solve.System`'s facts (``points`` a component),
        the components a block, and the program's counters over the traced
        stretch."""
        return dict(super().facts(), nrhs=self.nrhs, **self.stretch_counters)

    def step(self, i: int) -> SolveRecord:
        """Solve pool block ``i mod pool`` and wait for it."""
        from torch.autograd import profiler

        k = i % len(self.pool)
        traced = profiler._is_profiler_enabled
        before = _program_counters() if traced else None
        t0 = time.perf_counter()
        res = self.solve(self.pool[k])
        self._sync()
        wall = time.perf_counter() - t0
        if traced:
            after = _program_counters()
            for name in COUNTERS:
                have = self.stretch_counters[name]
                self.stretch_counters[name] = (
                    None if have is None or after[name] is None
                    else have + after[name] - (before[name] or 0))
        ans = Answer(res.x, [int(v) for v in res.iterations.reshape(-1)],
                     [float(v) for v in res.rel_residual.reshape(-1)],
                     [bool(v) for v in res.breakdown.reshape(-1)])
        if k in self.checked:
            self.kept[k] = ans
        return SolveRecord(k, max(ans.iterations), max(ans.rel_residual), self.failed(ans),
                           wall)

    def failed(self, ans: Answer) -> bool:
        """A block solve fails when any component breaks down, stops short
        of the traffic's iterations, or ends with a residual that is not
        finite, or when the block has not ``nrhs`` components."""
        want = int(self.traffic["iterations"])
        return (len(ans.iterations) != self.nrhs or any(ans.breakdown)
                or any(n != want for n in ans.iterations)
                or not all(math.isfinite(r) for r in ans.rel_residual))

    # -- the check ----------------------------------------------------------

    def reference_answer(self, k: int, precision: str) -> Answer:
        """The segregated reference's solves of pool block ``k`` in
        ``precision``, one component after another."""
        prec = PRECISIONS[precision]
        if precision not in self._stored:
            self._stored = {}                  # one precision's fields at a time
            self._stored[precision] = {n: prec.store(f) for n, f in self.fields.items()}
        fields = self._stored[precision]
        apply_A = lambda v: prec.store(ref_stencil.apply(fields, self.offsets, v, prec.compute))
        res = segregated.solve(apply_A, self.pool[k], tol=0.0,
                               maxiter=int(self.traffic["iterations"]), prec=prec,
                               solver=self.traffic["solver"])
        return Answer(torch.stack([r.x for r in res]), [r.iterations for r in res],
                      [r.rel_residual for r in res], [r.breakdown for r in res])

    def numbers(self, answers: dict[int, Answer]) -> dict:
        """The numbers ``correct`` compares, each the worst over the checked
        blocks' components.  A reading that is not finite, or a component
        missing, counts as infinite."""
        out = dict(x_gap=0.0, x_gap_max=0.0, res_ratio=0.0)

        def worst(name: str, value: float) -> None:
            out[name] = max(out[name], value if math.isfinite(value) else math.inf)

        for k in self.checked:
            got = answers.get(k)
            if got is None or tuple(got.x.shape) != (self.nrhs,) + self.shape:
                for name in out:
                    worst(name, math.inf)
                continue
            want = self.reference_answer(k, self.config["policy"])
            b = self.pool[k]
            for c in range(self.nrhs):
                worst("x_gap", _norm2(got.x[c], want.x[c]) / max(_norm2(want.x[c]), 1e-300))
                worst("x_gap_max", _amax(got.x[c], want.x[c]) / max(_amax(want.x[c]), 1e-300))
                worst("res_ratio", self._true_residual(b[c], got.x[c])
                      / max(self._true_residual(b[c], want.x[c]), 1e-300))
            del want
        return out
