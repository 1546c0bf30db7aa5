"""Finds every piece of a cell by the name ``BENCHMARK.json`` gives it.

* a configuration: the file that its ``configs`` entry names (JSON);
* a traffic mix: ``traffic/<name>.json``;
* a metric: ``metrics/<name>.py`` (a small reader, ``read(run)``);
* a system module: ``systems/<name>.py``, named by the configuration's
  ``system`` key;
* an operator's reference formula: ``reference/operators/<name>.py``;
* a cell's limits of ``correct``: ``limits/<cell>.json``.

Adding a cell, a mix, a metric or an operator adds files; no file here
names one.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def load_config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    return _json(root / config_entry(manifest, name)["file"])


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "traffic" / f"{name}.json")


def load_limits(cell: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The numbers ``correct`` compares for ``cell`` and their limits (the
    file also keeps the readings they were set from)."""
    return _json(bench_dir / "limits" / f"{cell}.json")["limits"]


def _module(package: str, kind: str, name: str, bench_dir: Path):
    if not (bench_dir / kind.replace(".", "/") / f"{name}.py").is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} under {bench_dir}")
    return importlib.import_module(f"{package}.{kind}.{name}")


def metric(name: str, bench_dir: Path = BENCH_DIR):
    return _module(bench_dir.name, "metrics", name, bench_dir)


def system(name: str, bench_dir: Path = BENCH_DIR):
    return _module(bench_dir.name, "systems", name, bench_dir)


def operator(name: str, bench_dir: Path = BENCH_DIR):
    return _module(bench_dir.name, "reference.operators", name, bench_dir)


def metrics_of_cell(manifest: dict, cell: str, traced: bool) -> list[dict]:
    """The metric entries a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced.  A metric without a
    ``workloads`` key belongs to every cell (a per-layer one, to every cell
    that reports the end-to-end metric it moves)."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]
