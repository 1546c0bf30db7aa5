"""One run of one cell: set-up, the measured window, the check, the line.

:func:`run_cell` is the run without the look for a card, so the tests can
drive it on the CPU at a small size; :func:`main` is what ``run.py`` calls.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

from perfbench import devtrace, registry

#: host seconds of whole solves the traced run profiles, from the window's start
TRACE_STRETCH_S = 4.0
#: top-level module names the printing process may not hold once the window closes
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (``perfbench/metrics/*.py``)."""
    cell: str
    config: dict
    traffic: dict
    facts: dict                    # points, n_fields, itemsize, solver
    device_kind: str
    setup_s: float
    window_s: float
    solves: list                   # SolveRecords of the window
    memory_peak_bytes: int
    stretch: devtrace.Stretch | None = None
    stretch_solves: list = dataclasses.field(default_factory=list)
    handwritten: frozenset = frozenset()

    @property
    def iterations(self) -> int:
        return sum(s.iterations for s in self.solves)

    @property
    def stretch_iterations(self) -> int:
        return sum(s.iterations for s in self.stretch_solves)


def _profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _handwritten() -> frozenset:
    import importlib.util

    spec = importlib.util.find_spec("repro_torch.kernels")
    return devtrace.handwritten_kernels(Path(spec.submodule_search_locations[0]) / "csrc")


def run_cell(manifest: dict, cell_name: str, *, seed: int, seconds: float, traced: bool,
             device: str, t_start: float, wrap=None, traffic_override: dict | None = None):
    """Set up ``cell_name``, run its window, judge it.  Returns ``(result,
    check_lines)``: the result line's object and the lines of the check."""
    import torch

    from torch.profiler import record_function

    cell = registry.workload(manifest, cell_name)
    config = registry.load_config(manifest, cell["config"])
    traffic = dict(registry.load_traffic(cell["traffic"]), **(traffic_override or {}))
    lim = registry.load_limits(cell_name)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    sut = registry.system(config["system"]).System(config, traffic, seed, device, wrap=wrap)
    sut.step(0)                                       # the warm solve
    setup_s = time.time() - t_start

    solves, stretch_solves, stretch = [], [], None
    prof = _profile() if traced else contextlib.nullcontext()
    with prof:                      # started before the window, stopped inside it
        t0 = time.perf_counter()
        mark = record_function(devtrace.STRETCH) if traced else contextlib.nullcontext()
        with mark:
            while not solves or time.perf_counter() - t0 < min(TRACE_STRETCH_S, seconds):
                with record_function("perfbench.solve"):
                    solves.append(sut.step(len(solves)))
    if traced:
        stretch_solves = list(solves)
    while time.perf_counter() - t0 < seconds:
        solves.append(sut.step(len(solves)))
    window_s = time.perf_counter() - t0

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    facts = sut.facts()
    if traced:
        stretch = devtrace.reduce_events(prof.events())
    sut.close_window()

    nums = sut.numbers(sut.kept)
    failed = sum(s.failed for s in solves)
    correct = failed == 0 and all(nums[k] <= lim[k] for k in lim)

    kind = torch.cuda.get_device_name() if on_card else "cpu"
    rec = RunRecord(cell_name, config, traffic, facts, kind, setup_s, window_s, solves, peak,
                    stretch, stretch_solves, _handwritten() if traced else frozenset())
    metrics = {}
    for m in registry.metrics_of_cell(manifest, cell_name, traced):
        value = registry.metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(solves),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": peak,
                   "power_limit_w": _power_limit() if on_card else None},
    }
    if traced:
        result["device"].update(busy_s=stretch.busy_s, window_s=stretch.window_s)
        result["breakdown"] = {"device_ops": stretch.device_ops(),
                               "idle_gaps": stretch.idle_gaps()}
    check = {k: {"value": nums[k], "limit": lim[k]} for k in lim}
    check["failed_solves"] = {"value": failed, "limit": 0}
    result["check"] = check
    walls = sorted(s.wall_s for s in solves)
    lines = [f"window: {window_s!r} s, {len(solves)} solves of {walls[0]!r} .. "
             f"{walls[len(walls) // 2]!r} .. {walls[-1]!r} s"]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in check.items()]
    return result, lines


def _power_limit() -> float | None:
    """The card's power limit in watts, from ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> list[str]:
    """Top-level module names in ``sys.modules`` that this process may not
    hold, compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, t_start: float) -> int:
    args = parse_args(argv)
    manifest = registry.load_manifest()
    cell = registry.workload(manifest, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device (torch.cuda.is_available() is False); "
              "the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run_cell(manifest, args.workload, seed=args.seed, seconds=args.seconds,
                             traced=bool(args.trace), device="cuda", t_start=t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"perfbench: the process holds {leaked} after the window", file=sys.stderr)
        return 3
    bad = [k for k, v in result["metrics"].items() if not math.isfinite(v["value"])]
    if bad:
        print(f"perfbench: metrics {bad} are not finite", file=sys.stderr)
        return 4
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0
