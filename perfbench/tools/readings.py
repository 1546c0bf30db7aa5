"""The readings a cell's limits of ``correct`` are set from, in one process
on the card, at the cell's own size.

    python3 perfbench/tools/readings.py --workload <cell> [--seeds 12] [--control-seeds 3]

Lower readings: the program's answers (one solve of each pool entry the
run would check) judged exactly as a run judges them, for a dozen seeds.
Upper readings: the control, the reference in the precision below the
configuration's put in the program's place, judged the same way, for three
seeds.  Prints one JSON line per seed, then each number's largest lower and
smallest upper reading.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import registry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, nargs=3, default=None,
                    help="another mesh than the traffic's (rehearsals on the CPU only)")
    ap.add_argument("--iterations", type=int, default=None,
                    help="another count than the traffic's (to place the count)")
    args = ap.parse_args(argv)

    import torch

    manifest = registry.load_manifest()
    cell = registry.workload(manifest, args.workload)
    config = registry.load_config(manifest, cell["config"])
    traffic = registry.load_traffic(cell["traffic"])
    if args.mesh:
        traffic["mesh"] = args.mesh
    if args.iterations:
        traffic["iterations"] = args.iterations
    sysmod = registry.system(config["system"])
    lower: dict[str, float] = {}
    upper: dict[str, float] = {}
    seeds = range(args.first_seed, args.first_seed + args.seeds)
    for kind, chosen in (("program", seeds), ("control", list(seeds)[:args.control_seeds])):
        for seed in chosen:
            t0 = time.perf_counter()
            sut = sysmod.System(config, traffic, seed, args.device)
            if kind == "program":
                for k in sut.checked:
                    sut.step(k)
                answers = sut.kept
            else:
                answers = sut.control_answers()
            nums = sut.numbers(answers)
            rel = {k: a.rel_residual for k, a in answers.items()}
            print(json.dumps(dict(kind=kind, seed=seed, rel_residual=rel,
                                  failed=sum(sut.failed(a) for a in answers.values()),
                                  **nums)),
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            into = lower if kind == "program" else upper
            pick = max if kind == "program" else min
            for k, v in nums.items():
                into[k] = pick(into.get(k, v), v)
            del sut, answers
            if torch.device(args.device).type == "cuda":
                torch.cuda.empty_cache()
    print(json.dumps(dict(workload=args.workload, iterations=traffic["iterations"],
                          lower=lower, upper=upper,
                          ratio={k: upper[k] / lower[k] if lower[k] else math.inf
                                 for k in lower if k in upper})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
