"""The port's import boundary: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro`` (only the tests import both)."""

import ast
import json
import os
import pathlib

import pytest

pytest.importorskip("torch")

from _torch_port import REPO, run_python  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    root = pathlib.Path(REPO)
    return sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_scan_covers_the_package():
    names = {os.path.relpath(p, REPO) for p in _port_files()}
    assert "chip_smoke.py" in names and len(names) >= 20
    assert "src/repro_torch/launch/solve.py" in names


def test_entry_point_loads_neither_package():
    out = run_python("""
        import json, sys
        import repro_torch.launch.solve, repro_torch.kernels.stencil_nd.ops
        import repro_torch.kernels.fused_iter.ops
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    """)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
