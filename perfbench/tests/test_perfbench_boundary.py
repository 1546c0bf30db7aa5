"""The benchmark's boundary: nothing under ``perfbench/`` imports JAX or the
JAX package, and the reference imports nothing of the program.  Top-level
module names are compared whole, so ``repro_torch`` is not ``repro``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


MODULES = sorted(BENCH.rglob("*.py"))


def test_modules_found():
    assert len(MODULES) > 20


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & (FORBIDDEN | {"repro_torch"})


def test_top_level_names_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro_torch import kernels\n")
    assert not _imports(f) & FORBIDDEN
    f.write_text("import repro.core\n")
    assert _imports(f) & FORBIDDEN
    f.write_text("from jax import numpy\n")
    assert _imports(f) & FORBIDDEN


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    import sys
    import types

    from perfbench import harness

    monkeypatch.setitem(sys.modules, "repro_torch.fake", types.ModuleType("fake"))
    assert "repro_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("fake"))
    assert "jaxlib" in harness.forbidden_modules()
