#!/usr/bin/env python3
"""Time the port's measured solve paths several times in one process on one GPU.

    python3 scripts/time_solves.py [--repeats 4] [--src DIR] [--out build/time_solves.json]

The paths are chip_smoke.py's: the CLI's main path at 608x608x1536
(``cs1_paper``, ``--backend fused --policy bf16_mixed --tol 0 --maxiter
30``), its ``--nrhs 4`` form at 608^3, ``solve_ref_fused`` at 608x608x1536
in bf16 for 30 iterations, and phase 8b's solver and preconditioner paths
at 608x608x1536 (``solve_distributed`` on the system of ``--seed 0``, built
once), where the package has them.  Each runs ``--repeats`` times in a
row: the first run allocates its tensors afresh (chip_smoke.py's phases 4,
5, 7 and 8b are such first runs), the later ones find them in PyTorch's
allocator cache.  ms/iter is host wall time around the solve, ending in a
synchronise, over its iterations.  ``--src`` takes the package from
another checkout (default: this one), so two commits can be timed in turns
on one card.  Prints one JSON line per path and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 30


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "time_solves.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_solves: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.core import bicgstab, precision, stencil
    from repro_torch.core.solvers import SOLVERS
    from repro_torch.launch import solve
    from repro_torch.launch.mesh import make_mesh_for_devices

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cli = ["--backend", "fused", "--policy", "bf16_mixed", "--tol", "0", "--maxiter", str(ITERS)]
    paths = {"cs1_paper": ["--mesh", "608", "608", "1536", *cli],
             "batched_joule_600_x4": ["--mesh", "608", "608", "608", "--nrhs", "4", *cli]}
    record = dict(card=card, src=str(args.src), repeats=args.repeats, paths={})
    for name, argv_ in paths.items():
        ms = [solve.main(argv_)["ms_per_iter"] for _ in range(args.repeats)]
        record["paths"][name] = ms
        print(json.dumps(dict(path=name, ms_per_iter=ms)), flush=True)
        torch.cuda.empty_cache()

    dev = torch.device("cuda")
    shape = (608, 608, 1536)
    cf = stencil.convection_diffusion(shape, device=dev)
    x = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    b = stencil.rhs_for_solution(cf, x).to(torch.bfloat16)
    cf = cf.astype(torch.bfloat16)
    del x
    ms = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bicgstab.solve_ref_fused(cf, b, tol=0.0, maxiter=ITERS)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / int(res.iterations) * 1e3)
        del res
    record["paths"]["solve_ref_fused"] = ms
    print(json.dumps(dict(path="solve_ref_fused", ms_per_iter=ms)), flush=True)
    del cf, b
    torch.cuda.empty_cache()

    from repro_torch.core.precond import PRECONDS, PrecondConfig

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    mesh = make_mesh_for_devices()
    for name, path in chip_smoke.SLICE_PATHS.items():
        solver, problem, precond = path.solver, path.problem, path.precond
        if solver not in SOLVERS or precond not in PRECONDS:
            continue
        _, cf, b = solve.manufactured_system(problem, stencil.STAR7, shape, seed=0, device=dev,
                                             solver=solver)
        b = b.to(torch.bfloat16)
        ms = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = bicgstab.solve_distributed(
                mesh, cf, b, tol=0.0, maxiter=ITERS, policy=precision.MIXED, solver=solver,
                backend="fused",
                precond=PrecondConfig(name=precond, degree=chip_smoke.CHEB_DEGREE))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) / int(res.iterations) * 1e3)
            del res
        record["paths"][name] = ms
        print(json.dumps(dict(path=name, ms_per_iter=ms)), flush=True)
        del cf, b
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
