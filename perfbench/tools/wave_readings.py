"""The readings the wave cell's limits of ``correct`` are set from, in one
process on the card, at the cell's own size.

    python3 perfbench/tools/wave_readings.py [--seeds 12] [--control-seeds 3]

Lower readings: the program's answers (one shot of each pool entry a run
would check, and the step check) judged exactly as a run judges them, for a
dozen seeds.  Upper readings: each control of ``systems/wave_shots.py``
(bf16 wavefield storage; the 13-point Laplacian) put in the program's place
and judged the same way, for three seeds.  Prints one JSON line per seed,
then each number's largest lower and, per control, smallest upper reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import registry  # noqa: E402

CELL = "rtm_star25.shots"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, nargs=3, default=None,
                    help="another mesh than the traffic's (rehearsals on the CPU only)")
    args = ap.parse_args(argv)

    import torch

    manifest = registry.load_manifest()
    cell = registry.workload(manifest, CELL)
    config = registry.load_config(manifest, cell["config"])
    traffic = registry.load_traffic(cell["traffic"])
    if args.mesh:
        traffic["mesh"] = args.mesh
    sysmod = registry.system(config["system"])
    lower: dict[str, float] = {}
    upper: dict[str, dict[str, float]] = {}
    seeds = list(range(args.first_seed, args.first_seed + args.seeds))
    runs = [("program", s) for s in seeds]
    runs += [(c, s) for c in sorted(sysmod.CONTROLS) for s in seeds[:args.control_seeds]]
    for kind, seed in runs:
        t0 = time.perf_counter()
        sut = sysmod.System(config, traffic, seed, args.device)
        if kind == "program":
            failed = sum(sut.step(k).failed for k in sut.checked)
            sut.close_window()
            answers = sut.kept
        else:
            failed = 0
            sut.close_window()
            answers = sut.control_answers(kind)
        nums = sut.numbers(answers)
        print(json.dumps(dict(kind=kind, seed=seed, checked=sut.checked, failed=failed,
                              **nums)), f"({time.perf_counter() - t0:.1f} s)", flush=True)
        into = lower if kind == "program" else upper.setdefault(kind, {})
        pick = max if kind == "program" else min
        for k, v in nums.items():
            into[k] = pick(into.get(k, v), v)
        del sut, answers
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(dict(workload=CELL, steps=traffic["iterations"], lower=lower,
                          upper=upper)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
