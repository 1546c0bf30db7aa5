"""The port's CFD entry point, ``python -m repro_torch.launch.cfd``: the
reference's flags plus ``--device``, its device rule, its printed report,
the Ghia verdict's exit code and the observability bundle."""

import ast
import json
import os

import pytest

torch = pytest.importorskip("torch")

from _torch_port import REPO, run_module  # noqa: E402
from repro_torch.launch import cfd  # noqa: E402
from repro_torch.obs import manifest  # noqa: E402

SMALL = ["--device", "cpu", "--n", "12", "--outer", "60", "--no-check"]


def test_cli_accepts_every_flag_of_the_reference():
    """Every option ``python -m repro.launch.cfd`` declares, the port's
    parser declares too, with the same choices where the port runs them,
    plus ``--device``."""
    src = open(os.path.join(REPO, "src", "repro", "launch", "cfd.py")).read()
    ref = {a.value for node in ast.walk(ast.parse(src)) if isinstance(node, ast.Call)
           and getattr(node.func, "attr", None) == "add_argument"
           for a in node.args if isinstance(a, ast.Constant) and str(a.value).startswith("--")}
    assert {"--scenario", "--raw-coeffs", "--checkpoint-dir", "--obs", "--run-dir"} <= ref
    actions = {opt: a for a in cfd.build_parser()._actions for opt in a.option_strings}
    assert ref | {"--device"} <= set(actions), sorted(ref - set(actions))
    assert actions["--device"].default == "cuda"
    assert actions["--backend"].choices == ["reference", "spmd"]


def test_cli_cpu_run_in_a_subprocess():
    out = run_module("repro_torch.launch.cfd", *SMALL)
    assert out.returncode == 0, out.stderr
    assert "SIMPLE cavity n=12 Re=100 on fabric {'data': 1, 'model': 1}" in out.stdout
    assert "device=cpu" in out.stdout and "outer iterations:" in out.stdout
    assert "centerline u: min=" in out.stdout and "centerline check" not in out.stdout


def test_cli_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default --device cuda runs")
    out = run_module("repro_torch.launch.cfd", "--n", "8")
    assert out.returncode != 0
    assert "--device cpu" in out.stderr


def test_cli_refuses_the_fused_backend():
    out = run_module("repro_torch.launch.cfd", "--device", "cpu", "--backend", "fused")
    assert out.returncode == 2
    assert "invalid choice: 'fused'" in out.stderr


def test_main_reports_the_ghia_verdict(capsys):
    res = cfd.main(["--device", "cpu", "--n", "16", "--tol", "1e-5"])
    printed = capsys.readouterr().out
    assert res["converged"] and res["ghia_ok"] and res["device"] == "cpu"
    assert f"outer iterations: {res['outer_iterations']}" in printed
    assert printed.count("[ok]") == 4 and "[FAIL]" not in printed
    u, v, p = res["state"]
    assert u.shape == (16, 16) and u.device.type == "cpu"
    # an undeveloped flow fails the check: exit 1 after the report
    with pytest.raises(SystemExit) as exc:
        cfd.main(["--device", "cpu", "--n", "12", "--outer", "2"])
    assert exc.value.code == 1
    printed = capsys.readouterr().out
    assert "[FAIL]" in printed and "WARNING: did not reach --tol" in printed


def test_main_channel_transient_with_checkpoints(tmp_path, capsys):
    args = ["--device", "cpu", "--scenario", "channel", "--n", "8", "--re", "50",
            "--dt", "0.05", "--steps", "2", "--outers-per-step", "3",
            "--checkpoint-dir", str(tmp_path)]
    res = cfd.main(args)
    printed = capsys.readouterr().out
    assert res["steps"] == 2 and res["outflux"] == pytest.approx(1.0, abs=1e-5)
    assert "channel: outlet flux 1.0000 (inflow 1)" in printed
    assert "2 steps of dt=0.05" in printed
    assert os.path.exists(tmp_path / "step_000000002.json")
    res = cfd.main(args[:-4] + ["--steps", "3", "--checkpoint-dir", str(tmp_path)])
    assert res["steps"] == 1                  # resumed at step 2


def test_cli_obs_bundle(tmp_path):
    res = cfd.main(SMALL + ["--run-dir", str(tmp_path / "run")])
    man = manifest.load_manifest(res["run_dir"])
    assert manifest.validate_manifest(man) == [] and man["kind"] == "cfd"
    assert man["metrics"]["counters"]["cfd.outer_iterations"] == res["outer_iterations"]
    with open(tmp_path / "run" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    steady = [e for e in events if e["event"] == "cfd_steady"]
    assert len(steady) == 1 and steady[0]["outer_iterations"] == res["outer_iterations"]
    trace = json.loads((tmp_path / "run" / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"cfd.outer", "operator.build"} <= names


def test_cli_profile_writes_a_torch_trace(tmp_path):
    cfd.main(["--device", "cpu", "--n", "8", "--outer", "3", "--no-check", "--profile",
              "--run-dir", str(tmp_path / "run")])
    assert (tmp_path / "run" / "torch_profile" / "torch_trace.json").exists()
