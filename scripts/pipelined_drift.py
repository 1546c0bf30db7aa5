#!/usr/bin/env python3
"""How far bf16 pipelined CG's x drifts from its recurrence residual, by dot
semantics and mesh size.

    python3 scripts/pipelined_drift.py                      # on the GPU
    python3 scripts/pipelined_drift.py --device cpu --shapes 32,32,24 64,64,48

For each mesh and seed: the CLI's Poisson system for ``--solver
pipelined_cg`` (``--seed``), ``bf16_mixed``, 30 iterations at tol 0,
pipelined CG and CG, each through

* ``fused``: the kernels; K5 rounds each product to bf16 before its f32
  sum, as the JAX package's ``_dot_kernel`` does;
* ``plain_k5``: the spmd operator with K5's semantics as plain tensor ops
  (``dot_mixed_ref``, another summation order);
* ``spmd``: the spmd backend, whose ``Policy.dot`` takes exact products, as
  the JAX package's spmd backend does;
* ``fused_spmd_dots``: the kernels with ``Policy.dot`` dots
  (``chip_smoke.with_spmd_dots``), which should be ``spmd`` bit for bit.

Each gives its recurrence and true relative residuals; one JSON line per
mesh and seed, a summary at the end, the record in ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 30


def _variants(cf, policy):
    import chip_smoke as cs
    from repro_torch.core.operator import make_operator
    from repro_torch.kernels.fused_iter.ref import dot_mixed_ref

    yield "fused", make_operator("fused", cf, policy=policy)
    spmd = make_operator("spmd", cf, policy=policy)
    yield "plain_k5", dataclasses.replace(
        spmd, dots=lambda pairs, p: spmd.reduce_partials([dot_mixed_ref(a, b) for a, b in pairs]))
    yield "spmd", spmd
    yield "fused_spmd_dots", cs.with_spmd_dots(make_operator("fused", cf, policy=policy))


def run(torch, shape, seed: int, device) -> dict:
    from repro_torch.core import precision, stencil
    from repro_torch.core.solvers import get_solver
    from repro_torch.launch import solve

    mixed = precision.MIXED
    _, cf, b = solve.manufactured_system("poisson", stencil.STAR7, shape, seed=seed,
                                         device=device, solver="pipelined_cg")
    b16 = b.to(torch.bfloat16)
    row, xs = dict(shape=list(shape), seed=seed), {}
    for name, op in _variants(cf, mixed):
        for solver in ("pipelined_cg", "cg"):
            res = get_solver(solver)(op, b16, None, tol=0.0, maxiter=ITERS, policy=mixed)
            row[f"{name}/{solver}"] = dict(rel_residual=float(res.rel_residual),
                                           true_rel_residual=solve._true_rel_residual(
                                               cf, res.x, b))
            if solver == "pipelined_cg" and name in ("spmd", "fused_spmd_dots"):
                xs[name] = res.x
            del res
        del op
    row["fused_spmd_dots_bitwise_spmd"] = bool(xs["fused_spmd_dots"].equal(xs["spmd"]))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--shapes", nargs="+", default=["152,152,384", "304,304,768",
                                                     "608,608,1536"],
                    help="meshes as X,Y,Z")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "pipelined_drift.json")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("pipelined_drift: no GPU (--device cpu runs on the host)", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    for text in args.shapes:
        shape = tuple(int(s) for s in text.split(","))
        for seed in range(args.seeds):
            rows.append(run(torch, shape, seed, torch.device(args.device)))
            print(json.dumps(rows[-1]), flush=True)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    summary = {}
    for row in rows:
        key = "x".join(map(str, row["shape"]))
        s = summary.setdefault(key, {"fused_over_spmd": [], "fused_over_plain_k5": [],
                                     "fused_spmd_dots_bitwise_spmd": []})
        true = {k.split("/")[0]: v["true_rel_residual"] for k, v in row.items()
                if k.endswith("/pipelined_cg")}
        s["fused_over_spmd"].append(true["fused"] / true["spmd"])
        s["fused_over_plain_k5"].append(true["fused"] / true["plain_k5"])
        s["fused_spmd_dots_bitwise_spmd"].append(row["fused_spmd_dots_bitwise_spmd"])
    print(json.dumps(dict(summary=summary)), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=card, rows=rows, summary=summary), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
