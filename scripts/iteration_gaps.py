#!/usr/bin/env python3
"""How far the dots' summation order moves f32 iteration counts at the
CLI's default cell (48x48x32, tol 1e-6), over many seeds, on one GPU.

    python3 scripts/iteration_gaps.py [--seeds 20] [--out build/iteration_gaps.json]

For each seed, the system of ``--seed`` (drawn on the host, so the CPU
replays it) is solved by:

* phase 3's BiCGStab on convdiff: the fused kernels, the spmd backend on
  the card, the same spmd solve on the CPU (the card's and the host's
  ``torch.dot`` sum in different orders), the fused backend on the CPU (the
  kernels' plain versions), the fused kernels with spmd-order dots, and
  ``solve_ref_fused``;
* each of ``chip_smoke.py``'s phase 8a paths: the fused kernels and the
  spmd backend on the card, and both backends on the CPU.

It prints one JSON line per seed with every count, convergence and
breakdown flag and true residual, then a summary of the gaps per pair: the
spmd card-against-CPU gap is the summation order's effect with no kernel
involved.  Needs the package beside it (``src/``) and a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (48, 48, 32)


def _solve(torch, label, cf, b, backend, spmd_dots=False):
    import chip_smoke as cs
    from repro_torch.core import precision
    from repro_torch.core.operator import make_operator
    from repro_torch.core.precond import PrecondConfig, build_precond
    from repro_torch.core.solvers import get_solver
    from repro_torch.launch import solve

    path = cs.SLICE_PATHS.get(label)
    solver, precond, tol, maxiter = ((path.solver, path.precond, path.tol, cs.SLICE_MAXITER)
                                     if path else ("bicgstab", "none", 1e-6, 200))
    op = make_operator(backend, cf, policy=precision.F32)
    if spmd_dots:
        op = cs.with_spmd_dots(op)
    m = build_precond(PrecondConfig(name=precond, degree=cs.CHEB_DEGREE), op)
    res = get_solver(solver)(op, b, None, tol=tol, maxiter=maxiter, policy=precision.F32,
                             precond=m)
    return dict(iterations=int(res.iterations), converged=bool(res.converged),
                breakdown=bool(res.breakdown),
                true_rel_residual=solve._true_rel_residual(cf, res.x, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "iteration_gaps.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("iteration_gaps: needs a GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core import bicgstab, stencil
    from repro_torch.launch import solve

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rows = []
    for seed in range(args.seeds):
        row = {"seed": seed}
        for label, problem in [("phase3", "convdiff")] + [(k, v.problem) for k, v in
                                                          cs.SLICE_PATHS.items()]:
            sys_c = solve.manufactured_system(problem, stencil.STAR7, SHAPE, seed=seed,
                                              device=cuda)[1:]
            sys_h = solve.manufactured_system(problem, stencil.STAR7, SHAPE, seed=seed,
                                              device=cpu)[1:]
            rec = dict(fused=_solve(torch, label, *sys_c, "fused"),
                       spmd=_solve(torch, label, *sys_c, "spmd"),
                       spmd_cpu=_solve(torch, label, *sys_h, "spmd"),
                       fused_cpu=_solve(torch, label, *sys_h, "fused"))
            if label == "phase3":
                rec["spmd_order"] = _solve(torch, label, *sys_c, "fused", spmd_dots=True)
                r = bicgstab.solve_ref_fused(*sys_c, tol=1e-6, maxiter=200)
                rec["ref_fused"] = dict(iterations=int(r.iterations),
                                        converged=bool(r.converged))
            row[label] = rec
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for label in ["phase3", *cs.SLICE_PATHS]:
        pairs = [("fused", "spmd"), ("spmd", "spmd_cpu"), ("fused_cpu", "spmd_cpu")]
        if label == "phase3":
            pairs += [("ref_fused", "spmd"), ("spmd_order", "spmd")]
        summary[label] = {f"{a}-{b}": sorted(abs(r[label][a]["iterations"]
                                                 - r[label][b]["iterations"]) for r in rows)
                          for a, b in pairs}
        runs = ("fused", "spmd", "spmd_cpu", "fused_cpu")
        summary[label]["converged"] = {k: sum(r[label][k]["converged"] for r in rows)
                                       for k in runs}
        summary[label]["max_true_rel_residual"] = {
            k: max(r[label][k]["true_rel_residual"] for r in rows) for k in runs}
    print(json.dumps({"card": smi, "seeds": args.seeds, "summary": summary}), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, rows=rows, summary=summary), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
