"""Run manifests: a launch with ``--obs`` leaves a reproducible bundle under
``results/runs/<run_id>/``.

Counterpart of ``repro/obs/manifest.py``, in the same ``repro.obs.v1``
schema (``scripts/compare_runs.py`` reads both packages' bundles):

* ``manifest.json``: config cell, git SHA, torch/CUDA/numpy versions,
  device topology (the card's name and power limit), environment,
  wall time, and the final metrics snapshot, kernel launch counts included;
* ``events.jsonl``: the registry's structured events, one per line;
* ``trace.json``: completed spans as Chrome trace events (Perfetto).

Usage (what ``--obs`` wires up in ``launch/solve.py``)::

    ctx = manifest.start_run("solve", config=vars(args), profile=args.profile)
    ... run ...
    manifest.finish_run(ctx)

``start_run(profile=True)`` profiles into ``<run_dir>/torch_profile``; a
profiler that cannot start fails the run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import shutil
import subprocess
import sys
import time

from repro_torch.core import dist
from repro_torch.obs import metrics, trace

SCHEMA = "repro.obs.v1"
DEFAULT_ROOT = os.path.join("results", "runs")
PROFILE_DIR = "torch_profile"

# Environment variables that change which card runs, how memory is held,
# or which kernel plans are used.
_ENV_KEYS = ("CUDA_VISIBLE_DEVICES", "PYTORCH_CUDA_ALLOC_CONF")

_REQUIRED_FIELDS = ("schema", "run_id", "kind", "created_unix", "created",
                    "argv", "config", "git", "versions", "devices", "env",
                    "metrics", "wall_s")


def git_info() -> dict:
    """Best-effort git SHA/branch/dirty for the working tree."""
    def _run(*cmd):
        try:
            out = subprocess.run(["git", *cmd], capture_output=True, text=True, timeout=10)
            return out.stdout.strip() if out.returncode == 0 else None
        except Exception:
            return None

    sha = _run("rev-parse", "HEAD")
    return {
        "sha": sha or "unknown",
        "branch": _run("rev-parse", "--abbrev-ref", "HEAD") or "unknown",
        "dirty": bool(_run("status", "--porcelain")) if sha else None,
    }


def versions() -> dict:
    import numpy
    import torch

    return {"python": platform.python_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "numpy": numpy.__version__}


def nvidia_smi() -> list[str] | None:
    """``name, power.limit`` of each card as ``nvidia-smi`` reports it, or
    None where there is no ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_topology() -> dict:
    """The cards as torch sees them, with each one's power limit."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    smi = nvidia_smi()
    return {
        "platform": "gpu" if n else "cpu",
        "n_devices": n,
        "kinds": sorted({torch.cuda.get_device_name(i) for i in range(n)}),
        "nvidia_smi": smi,
        "power_limit": None if smi is None else [s.rsplit(",", 1)[-1].strip() for s in smi],
        "process_count": 1,
    }


def env_flags() -> dict:
    return {k: os.environ[k] for k in _ENV_KEYS if k in os.environ}


def new_run_id(kind: str) -> str:
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    return f"{stamp}-{kind}-{os.getpid() % 100000:05d}"


def _jsonable(obj):
    """Coerce argparse namespaces / dataclasses / tuples into JSON."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


@dataclasses.dataclass
class RunContext:
    run_id: str
    run_dir: str
    kind: str
    config: dict
    t_start: float
    profile: bool = False
    _profiler: trace.Profile | None = None


def start_run(kind: str, *, config: dict | None = None, run_dir: str | None = None,
              root: str = DEFAULT_ROOT, profile: bool = False,
              profile_cuda: bool | None = None) -> RunContext:
    """Open a run bundle directory (creating it) and, with ``profile``,
    start ``torch.profiler`` into ``<run_dir>/torch_profile`` (CUDA activity
    included where ``profile_cuda``, by default where a card is present)."""
    run_id = new_run_id(kind)
    if run_dir is None:
        run_dir = os.path.join(root, run_id)
    os.makedirs(run_dir, exist_ok=True)
    ctx = RunContext(run_id=run_id, run_dir=run_dir, kind=kind,
                     config=_jsonable(config or {}), t_start=time.time(), profile=profile)
    if profile:
        ctx._profiler = trace.Profile(os.path.join(run_dir, PROFILE_DIR), cuda=profile_cuda)
    metrics.event("run_start", run_id=run_id, kind=kind)
    return ctx


def finish_run(ctx: RunContext, *, extra: dict | None = None, failed: bool = False) -> dict:
    """Stop the profiler, copy the kernel launch counts into
    ``kernels.<name>.launches`` gauges (the fused group passes'
    element-wise launches into ``kernels.<name>.element_wise_launches``, the
    batched stencil's right-hand sides into ``kernels.<name>.rhs``), and
    write ``manifest.json``,
    ``events.jsonl`` and ``trace.json``.  ``failed`` (the run raised) stops
    the profiler without its device-activity check, so the run's own error
    is the one raised."""
    from repro_torch.kernels import element_wise_launch_counts, launch_counts, rhs_counts

    if ctx._profiler is not None:
        prof, ctx._profiler = ctx._profiler, None
        prof.stop(check=not failed)
    for name, n in launch_counts().items():
        metrics.gauge(f"kernels.{name}.launches").set(n)
    for name, n in element_wise_launch_counts().items():
        metrics.gauge(f"kernels.{name}.element_wise_launches").set(n)
    for name, n in rhs_counts().items():
        metrics.gauge(f"kernels.{name}.rhs").set(n)
    wall = time.time() - ctx.t_start
    metrics.event("run_finish", run_id=ctx.run_id, wall_s=wall)

    man = {
        "schema": SCHEMA,
        "run_id": ctx.run_id,
        "kind": ctx.kind,
        "created_unix": ctx.t_start,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ctx.t_start)),
        "argv": list(sys.argv),
        "config": ctx.config,
        "git": git_info(),
        "versions": versions(),
        "devices": device_topology(),
        "dist": dist.describe(),
        "env": env_flags(),
        "metrics": metrics.snapshot(),
        "wall_s": wall,
    }
    if extra:
        man.update(_jsonable(extra))

    with open(os.path.join(ctx.run_dir, "events.jsonl"), "w") as f:
        for ev in metrics.events():
            f.write(json.dumps(_jsonable(ev)) + "\n")
    with open(os.path.join(ctx.run_dir, "trace.json"), "w") as f:
        json.dump(trace.chrome_trace(), f)
    with open(os.path.join(ctx.run_dir, "manifest.json"), "w") as f:
        json.dump(man, f, indent=2)
    return man


def run_bundled(kind: str, args, device, run) -> dict:
    """``run(args, device)`` recorded into a run bundle (what ``--obs``
    does): the registry and the spans start empty, spans synchronise the
    card, ``args.profile``/``args.run_dir`` configure the bundle, and the
    bundle is written whether or not the run raises (a raising run's
    profile skips its device-activity check, so the run's own error is the
    one raised).  Returns the run's dict with ``run_dir`` added."""
    if not dist.is_root():
        return run(args, device)       # rank 0 alone writes the bundle
    metrics.reset()
    trace.reset()
    trace.enable(sync=True)
    ctx = start_run(kind, config=vars(args), run_dir=args.run_dir, profile=args.profile,
                    profile_cuda=device.type == "cuda")
    failed = True
    try:
        out = run(args, device)
        failed = False
    finally:
        try:
            finish_run(ctx, failed=failed)
        finally:
            trace.disable()
        print(f"run bundle: {ctx.run_dir}")
    out["run_dir"] = ctx.run_dir
    return out


def validate_manifest(man: dict) -> list[str]:
    """Schema check used by tests and ``compare_runs``.  Returns a list of
    problems (empty == valid)."""
    problems = []
    for field in _REQUIRED_FIELDS:
        if field not in man:
            problems.append(f"missing field: {field}")
    if man.get("schema") != SCHEMA:
        problems.append(f"schema is {man.get('schema')!r}, want {SCHEMA!r}")
    if not isinstance(man.get("metrics"), dict):
        problems.append("metrics is not an object")
    else:
        for sub in ("counters", "gauges", "histograms"):
            if sub not in man["metrics"]:
                problems.append(f"metrics missing {sub!r}")
    git = man.get("git")
    if not (isinstance(git, dict) and "sha" in git):
        problems.append("git.sha missing")
    dev = man.get("devices")
    if not (isinstance(dev, dict) and "n_devices" in dev):
        problems.append("devices.n_devices missing")
    return problems


def load_manifest(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "manifest.json")) as f:
        return json.load(f)


def write_benchmark_bundle(name: str, record: dict, root: str = DEFAULT_ROOT) -> str:
    """One-shot bundle for a benchmark record: the record lands both as a
    ``benchmark_record`` event and as ``record.json`` next to the manifest.
    Returns the run directory."""
    ctx = start_run(f"bench-{name}", config={"benchmark": name}, root=root)
    metrics.event("benchmark_record", name=name, schema=record.get("schema"),
                  generated_by=record.get("generated_by"))
    with open(os.path.join(ctx.run_dir, "record.json"), "w") as f:
        json.dump(_jsonable(record), f, indent=2)
    finish_run(ctx, extra={"benchmark": name})
    return ctx.run_dir
