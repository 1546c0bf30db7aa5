"""The sweep that places a traffic mix's ``iterations`` against the
plateau of the program's precision: on the card, at the cell's own size,
the program's recurrence residual after each iteration of a solve run with
``tol = 0``, for every pool entry of a dozen seeds.

    python3 perfbench/tools/tol_sweep.py --workload <cell> [--seeds 12] [--maxiter 80]

For each right-hand side it prints the lowest recurrence residual the solve
reached, the iteration it was reached at, and the iterations to each of
5e-2 .. 1e-6; then, over all of them, the residual after the traffic's
``iterations``, how many crossed each tolerance at each iteration, and the
range of the lowest residuals.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import registry  # noqa: E402

TOLS = (5e-2, 2e-2, 1e-2, 5e-3, 2e-3, 1e-3, 5e-4, 2e-4, 1e-4, 5e-5, 2e-5, 1e-5, 1e-6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--maxiter", type=int, default=80)
    ap.add_argument("--policy", default=None, help="another precision than the configuration's")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core import bicgstab
    from repro_torch.core.precision import get_policy
    from repro_torch.core.stencil import StencilCoeffs
    from repro_torch.launch.mesh import make_mesh_for_devices

    manifest = registry.load_manifest()
    cell = registry.workload(manifest, args.workload)
    config = registry.load_config(manifest, cell["config"])
    traffic = dict(registry.load_traffic(cell["traffic"]), check_sample=1)
    maxiter = args.maxiter
    sysmod = registry.system(config["system"])
    rows = []
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        t0 = time.perf_counter()
        sut = sysmod.System(config, traffic, seed, "cuda")
        coeffs = StencilCoeffs(dict(sut.fields))
        hists = []
        for b in sut.pool:
            res = bicgstab.solve_distributed(
                make_mesh_for_devices(), coeffs, b, tol=0.0, maxiter=maxiter,
                policy=get_policy(args.policy or config["policy"]), solver=traffic["solver"],
                backend=config["backend"], record_history=True)
            hists.append(res.history.float().cpu().reshape(-1, 1))
            del res
        hist = torch.cat(hists, dim=1)                     # [iterations, pool entry]
        del sut, coeffs
        torch.cuda.empty_cache()
        for j in range(hist.shape[1]):
            h = [float(v) for v in hist[:, j]]
            finite = [v for v in h if math.isfinite(v)]
            low = min(finite) if finite else math.inf
            reach = {t: next((i + 1 for i, v in enumerate(h) if v <= t), None) for t in TOLS}
            rows.append(dict(seed=seed, rhs=j, lowest=low, at=h.index(low) + 1 if finite else None,
                             reach={str(t): n for t, n in reach.items()},
                             history=[float(f"{v:.4g}") for v in h]))
            print(json.dumps(rows[-1]), f"({time.perf_counter() - t0:.1f} s)", flush=True)
            rows[-1]["h"] = h
    n = int(traffic["iterations"])
    after = [r["h"][n - 1] for r in rows]
    crossings = {str(t): dict(collections.Counter(r["reach"][str(t)] for r in rows))
                 for t in TOLS[:3]}
    print(json.dumps(dict(workload=args.workload, seeds=args.seeds, rhs=len(rows),
                          maxiter=maxiter, iterations=n, residual_after=[min(after), max(after)],
                          crossings=crossings, lowest=[min(r["lowest"] for r in rows),
                                                       max(r["lowest"] for r in rows)])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
