"""A closed stream of Krylov solves of a stencil system, through the port's
``repro_torch.core.bicgstab.solve_distributed`` on one rank.

Set-up makes the operator's float32 fields (the reference formula of the
configuration's operator) and a pool of right-hand sides ``b = A x_true``,
each ``x_true`` drawn on the device from (seed, pool index), ``b`` formed in
float32 by the reference apply and stored in the storage dtype, as the
port's CLI hands it.  Each step solves the next ``b`` of the pool from
``x0 = 0`` and waits for it, as a time-stepper waits before forming its next
right-hand side.  Every solve runs the traffic's ``iterations`` Krylov
iterations (a tolerance of 0), the program's and the reference's alike.  The
per-solve cast of the fields, the tuning-cache lookup and the operator build
are inside each solve, as a caller of the library pays them.

:meth:`System.numbers` judges the window's answers: for pool entries drawn
from the seed, the last answer the window produced for each, against the
plain reference's solve of the same ``b`` (``perfbench/reference``).
"""

from __future__ import annotations

import dataclasses
import math
import random
import time

import numpy as np
import torch

from perfbench import registry
from perfbench.reference import krylov as ref_krylov
from perfbench.reference import stencil as ref_stencil
from perfbench.reference.precision import CONTROL_OF, PRECISIONS

#: elements per chunk of a norm or a gap (their float64 copies stay small)
CHUNK = 1 << 26


def seed_for(seed: int, k: int) -> int:
    """The generator seed of pool entry ``k`` under the run's ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), k])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


@dataclasses.dataclass
class Answer:
    """What one solve produced: ``x``, its iterations and its recurrence
    residual, and whether it broke down."""
    x: torch.Tensor
    iterations: int
    rel_residual: float
    breakdown: bool


@dataclasses.dataclass
class SolveRecord:
    pool: int
    iterations: int
    rel_residual: float            # the recurrence residual the program reports
    failed: bool
    wall_s: float


def _norm2(a: torch.Tensor, b: torch.Tensor | None = None) -> float:
    """``||a - b||`` (or ``||a||``) in float64, chunk by chunk."""
    a = a.reshape(-1)
    b = None if b is None else b.reshape(-1)
    tot = 0.0
    for i in range(0, a.numel(), CHUNK):
        d = a[i:i + CHUNK].double()
        if b is not None:
            d = d - b[i:i + CHUNK].double()
        tot += float(d.square().sum())
    return math.sqrt(tot)


def _amax(a: torch.Tensor, b: torch.Tensor | None = None) -> float:
    """``max |a - b|`` (or ``max |a|``), chunk by chunk."""
    a = a.reshape(-1)
    b = None if b is None else b.reshape(-1)
    m = 0.0
    for i in range(0, a.numel(), CHUNK):
        d = a[i:i + CHUNK].double()
        if b is not None:
            d = d - b[i:i + CHUNK].double()
        m = max(m, float(d.abs().max()))
    return m


class System:
    """One cell's inputs and its timed call.  ``wrap`` replaces the port's
    solve by ``wrap(solve)`` (the tests plant faults with it)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, *, wrap=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        op = config["operator"]
        op_mod = registry.operator(op["kind"])
        self.offsets = op_mod.offsets(op["params"])
        self.shape = tuple(int(s) for s in traffic["mesh"])
        self.prec = PRECISIONS[config["policy"]]
        self.fields = op_mod.fields(self.shape, op["params"], self.device)
        self.pool = [self._rhs(k) for k in range(int(traffic["pool"]))]
        self.checked = sorted(random.Random(seed).sample(range(len(self.pool)),
                                                         int(traffic["check_sample"])))
        self.kept: dict[int, Answer] = {}
        self._stored: dict[str, dict] = {}      # the reference's stored fields
        self.solve = self._port_solve()
        if wrap is not None:
            self.solve = wrap(self.solve)

    def _rhs(self, k: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(seed_for(self.seed, k))
        x_true = torch.randn(self.shape, generator=gen, device=self.device, dtype=torch.float32)
        return self.prec.store(ref_stencil.apply_f32(self.fields, self.offsets, x_true))

    def _port_solve(self):
        from repro_torch.core import bicgstab
        from repro_torch.core.precision import get_policy
        from repro_torch.core.stencil import StencilCoeffs
        from repro_torch.launch.mesh import make_mesh_for_devices

        coeffs = StencilCoeffs(dict(self.fields))
        mesh = make_mesh_for_devices()
        kw = dict(tol=0.0, maxiter=int(self.traffic["iterations"]),
                  policy=get_policy(self.config["policy"]), solver=self.traffic["solver"],
                  backend=self.config["backend"])
        return lambda b: bicgstab.solve_distributed(mesh, coeffs, b, **kw)

    def facts(self) -> dict:
        """What the metrics' byte counts take from the cell: points, stored
        fields, the storage's bytes and the solver."""
        return dict(points=math.prod(self.shape), n_fields=len(self.offsets),
                    itemsize=torch.empty((), dtype=self.prec.compute).element_size(),
                    solver=self.traffic["solver"])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, i: int) -> SolveRecord:
        """Solve pool entry ``i mod pool`` and wait for it."""
        k = i % len(self.pool)
        t0 = time.perf_counter()
        res = self.solve(self.pool[k])
        self._sync()
        wall = time.perf_counter() - t0
        ans = Answer(res.x, int(res.iterations), float(res.rel_residual), bool(res.breakdown))
        if k in self.checked:
            self.kept[k] = ans
        return SolveRecord(k, ans.iterations, ans.rel_residual, self.failed(ans), wall)

    def failed(self, ans: Answer) -> bool:
        """A solve fails when it breaks down, stops short of the traffic's
        iterations, or ends with a residual that is not finite."""
        return (ans.breakdown or ans.iterations != int(self.traffic["iterations"])
                or not math.isfinite(ans.rel_residual))

    # -- the check ----------------------------------------------------------

    def reference_answer(self, k: int, precision: str) -> Answer:
        """The plain reference's solve of pool entry ``k`` in ``precision``."""
        prec = PRECISIONS[precision]
        if precision not in self._stored:
            self._stored = {}                  # one precision's fields at a time
            self._stored[precision] = {n: prec.store(f) for n, f in self.fields.items()}
        fields = self._stored[precision]
        apply_A = lambda v: prec.store(ref_stencil.apply(fields, self.offsets, v, prec.compute))
        r = ref_krylov.SOLVERS[self.traffic["solver"]](
            apply_A, self.pool[k], tol=0.0, maxiter=int(self.traffic["iterations"]), prec=prec)
        return Answer(r.x, r.iterations, r.rel_residual, r.breakdown)

    def control_answers(self) -> dict[int, Answer]:
        """The control put in the program's place: the reference in the
        precision below the configuration's, on the checked pool entries."""
        return {k: self.reference_answer(k, CONTROL_OF[self.config["policy"]])
                for k in self.checked}

    def _true_residual(self, b: torch.Tensor, x: torch.Tensor) -> float:
        """``||b - A x|| / ||b||`` with the float32 operator."""
        r = b.float() - ref_stencil.apply_f32(self.fields, self.offsets, x.float())
        return _norm2(r) / max(_norm2(b), 1e-300)

    def numbers(self, answers: dict[int, Answer]) -> dict:
        """The numbers ``correct`` compares, each the worst over the checked
        pool entries.  A reading that is not finite counts as infinite."""
        out = dict(x_gap=0.0, x_gap_max=0.0, res_ratio=0.0)

        def worst(name: str, value: float) -> None:
            out[name] = max(out[name], value if math.isfinite(value) else math.inf)

        for k in self.checked:
            got = answers.get(k)
            if got is None:
                for name in out:
                    worst(name, math.inf)
                continue
            want = self.reference_answer(k, self.config["policy"])
            b = self.pool[k]
            worst("x_gap", _norm2(got.x, want.x) / max(_norm2(want.x), 1e-300))
            worst("x_gap_max", _amax(got.x, want.x) / max(_amax(want.x), 1e-300))
            worst("res_ratio", self._true_residual(b, got.x)
                  / max(self._true_residual(b, want.x), 1e-300))
            del want
        return out

    def close_window(self) -> None:
        """Drop what the program holds beyond the kept answers."""
        self.solve = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
