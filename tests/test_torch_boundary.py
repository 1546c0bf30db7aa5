"""The port's import boundary: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro`` (only the tests import both),
nor ``ml_dtypes``, which the JAX package's checkpoints use and a card's
machine may lack."""

import ast
import json
import os
import pathlib

import pytest

pytest.importorskip("torch")

from _torch_port import REPO, run_python  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")
#: the port's examples, beside the JAX package's
EXAMPLES = ("serve_lm_torch.py", "quickstart_torch.py", "cfd_cavity_torch.py",
            "train_lm_torch.py")


def _port_files():
    root = pathlib.Path(REPO)
    return sorted((root / "src" / "repro_torch").rglob("*.py")) + [
        root / "chip_smoke.py"] + [root / "examples" / f for f in EXAMPLES]


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
    assert {"src/repro_torch/launch/cfd.py", "src/repro_torch/checkpoint/manager.py",
            "src/repro_torch/runtime/runner.py", "src/repro_torch/apps/cfd/driver.py"} <= names
    assert {"src/repro_torch/models/model.py", "src/repro_torch/configs/gemma3_12b.py",
            "src/repro_torch/configs/stencil_box27.py", "examples/serve_lm_torch.py",
            "examples/quickstart_torch.py", "examples/cfd_cavity_torch.py",
            "src/repro_torch/kernels/stencil7.py", "src/repro_torch/models/moe.py",
            "src/repro_torch/configs/qwen2_moe_a2_7b.py"} <= names
    assert {"src/repro_torch/models/rwkv6.py", "src/repro_torch/models/mamba.py"} | {
        f"src/repro_torch/configs/{a}.py" for a in (
            "rwkv6_7b", "jamba_v0_1_52b", "whisper_large_v3", "paligemma_3b",
            "grok_1_314b")} <= names
    assert {"src/repro_torch/data/pipeline.py", "src/repro_torch/optim/adamw.py",
            "src/repro_torch/optim/compress.py", "src/repro_torch/launch/train.py",
            "examples/train_lm_torch.py"} <= names


def test_entry_point_loads_neither_package():
    out = run_python("""
        import json, sys
        import repro_torch.launch.solve, repro_torch.kernels.stencil_nd.ops
        import repro_torch.kernels.fused_iter.ops
        import repro_torch.launch.cfd, repro_torch.core.simple_cfd
        import repro_torch.configs.cfd_scenarios, repro_torch.checkpoint, repro_torch.runtime
        import repro_torch.models.model, repro_torch.configs.stencil_box27
        import repro_torch.launch.train, repro_torch.data, repro_torch.optim
        from repro_torch.configs import all_configs
        all_configs()
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in %r)))
    """ % (FORBIDDEN,))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
