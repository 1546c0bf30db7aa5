"""``BENCHMARK.json`` against the files it names, and the harness's finding
of each piece by name, with nothing to edit when a piece is added."""

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from perfbench import registry

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = registry.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_found_by_name(cell):
    w = registry.workload(MANIFEST, cell)
    config = registry.load_config(MANIFEST, w["config"])
    assert config["name"] == w["config"]
    registry.system(config["system"])
    registry.operator(config["operator"]["kind"])
    traffic = registry.load_traffic(w["traffic"])
    assert {"mesh", "solver", "iterations", "pool", "check_sample"} <= set(traffic)
    assert list(traffic["mesh"]) in [list(m) for m in config["meshes"].values()]
    assert registry.load_limits(cell)
    assert w["chips"] == 1


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_modules_found_and_agree(m):
    mod = registry.metric(m["name"])
    assert mod.UNIT == m["unit"]
    if "layer" in m:
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert NAME.match(entry["name"]), entry["name"]
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in MANIFEST["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    names = [e["name"] for g in ("configs", "workloads") for e in MANIFEST[g]]
    assert len(set(names)) == len(names)
    assert len({m["name"] for m in METRICS}) == len(METRICS)


def test_bounds():
    by = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in by and by["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("m", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_moves_names_an_end_to_end_metric_each_cell_reports(m):
    for cell in m["workloads"]:
        reported = {e["name"] for e in registry.metrics_of_cell(MANIFEST, cell, traced=False)}
        assert m["moves"] in reported, (m["name"], cell)
        assert m in registry.metrics_of_cell(MANIFEST, cell, traced=True)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_and_a_layer(cell):
    e2e = {e["name"] for e in registry.metrics_of_cell(MANIFEST, cell, traced=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.metrics_of_cell(MANIFEST, cell, traced=True)


def test_added_pieces_found_without_editing_a_file(tmp_path):
    """A new configuration, mix, metric, operator and cell, added as files in a
    copy, are found by name; no file that was there is changed."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    bench = tmp_path / "perfbench"
    (bench / "configs" / "new_cfg.json").write_text(json.dumps(
        dict(name="new_cfg", system="krylov_solve", policy="bf16_mixed", backend="fused",
             meshes={"m": [8, 8, 8]},
             operator=dict(kind="new_op", stencil="star7", params={}))))
    (bench / "reference" / "operators" / "new_op.py").write_text(textwrap.dedent("""
        import torch
        from perfbench.reference.stencil import star_offsets
        def offsets(params):
            return star_offsets(1)
        def fields(shape, params, device):
            return {n: torch.full(shape, -0.1, device=device) for n, _ in offsets(params)}
        """))
    (bench / "traffic" / "new_mix.json").write_text(json.dumps(
        dict(mesh=[8, 8, 8], solver="bicgstab", iterations=8, pool=2,
             check_sample=1)))
    (bench / "metrics" / "new_metric.py").write_text("UNIT = 'x'\ndef read(run):\n    return 1.0\n")
    (bench / "limits" / "new_cfg.new_mix.json").write_text(json.dumps({"limits": {"x_gap": 0.1}}))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(name="new_cfg", source="x", reduced=[], why="x",
                                    file="perfbench/configs/new_cfg.json"))
    manifest["workloads"].append(dict(name="new_cfg.new_mix", config="new_cfg",
                                      traffic="new_mix", chips=1, why="x"))
    manifest["per_layer"].append(dict(name="new_metric", unit="x", better="lower",
                                      source="host_clock", layer="x", moves="ms_per_iter",
                                      workloads=["new_cfg.new_mix"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = textwrap.dedent(f"""
        import sys; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]
        import torch
        from perfbench import registry, harness
        m = registry.load_manifest()
        assert registry.__file__.startswith({str(tmp_path)!r})
        res, _ = harness.run_cell(m, "new_cfg.new_mix", seed=5, seconds=0.2, traced=False,
                                  device="cpu", t_start=0.0)
        assert res["correct"], res
        names = [e["name"] for e in registry.metrics_of_cell(m, "new_cfg.new_mix", True)]
        assert names == ["new_metric"], names
        print("ok")
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
    for p, data in before.items():
        assert p.read_bytes() == data, p
