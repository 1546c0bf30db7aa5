"""The port's entry point: ``python -m repro_torch.launch.solve``, its device
rule, and the kernel launch counters on CPU tensors."""

import pytest

torch = pytest.importorskip("torch")

from _torch_port import run_module  # noqa: E402
from repro_torch.core import bicgstab, precision, stencil  # noqa: E402
from repro_torch.core.precond import PrecondConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import solve  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402


def test_cli_cpu_fused_converges():
    out = run_module("repro_torch.launch.solve", "--device", "cpu", "--backend", "fused",
                     "--mesh", "8", "8", "8", "--policy", "f32")
    assert out.returncode == 0, out.stderr
    assert "converged: True" in out.stdout
    assert "backend=fused" in out.stdout and "device=cpu" in out.stdout
    assert "ms/iter on cpu" in out.stdout


def test_cli_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default --device cuda runs")
    out = run_module("repro_torch.launch.solve")
    assert out.returncode != 0
    assert "--device cpu" in out.stderr


def test_main_returns_what_it_printed(capsys):
    res = solve.main(["--device", "cpu", "--backend", "fused", "--mesh", "6", "6", "6",
                      "--policy", "f32", "--stencil", "box27", "--seed", "3"])
    printed = capsys.readouterr().out
    assert res["converged"] and f"iterations: {res['iterations']}" in printed
    assert res["problem"] == "random" and res["true_rel_residual"] < 1e-5
    # --nrhs 2: one block solve, per-RHS lines
    res = solve.main(["--device", "cpu", "--backend", "fused", "--mesh", "8", "8", "8",
                      "--policy", "f32", "--nrhs", "2"])
    printed = capsys.readouterr().out
    assert res["nrhs"] == 2 and all(res["converged"]) and len(res["iterations"]) == 2
    assert max(res["true_rel_residual"]) < 1e-5
    assert f"per-RHS iterations: {res['iterations']}" in printed
    assert "true rel-residuals (f32 check):" in printed and "for 2 RHS" in printed
    with pytest.raises(SystemExit):
        solve.main(["--device", "cpu", "--nrhs", "0"])


def test_cpu_tensors_launch_no_kernel():
    """On CPU tensors every kernel wrapper takes its plain version: a whole
    fused solve leaves every launch counter at 0."""
    shape = (6, 6, 6)
    cf = stencil.convection_diffusion(shape, device="cpu")
    b = stencil.rhs_for_solution(cf, torch.randn(shape, generator=torch.Generator().manual_seed(0)))
    reset_launch_counts()
    res = bicgstab.solve_ref(cf, b, tol=1e-5, maxiter=50, backend="fused",
                             policy=precision.MIXED)
    assert int(res.iterations) > 0
    unbatched = {"stencil_nd", "update_q_dots", "update_xr_dots", "update_p", "dot_mixed"}
    assert set(launch_counts()) == (unbatched | {n + "_batched" for n in unbatched}
                                    | {"stencil7_dot"})
    assert not any(launch_counts().values()), launch_counts()


@pytest.mark.parametrize("n,grid", [(1, (1, 1)), (2, (1, 2)), (4, (2, 2)), (8, (2, 4)),
                                    (6, (2, 3))])
def test_near_square_rank_grid(n, grid):
    mesh = make_mesh_for_devices(n)
    assert mesh.shape == {"data": grid[0], "model": grid[1]}
    assert mesh.size == n


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def test_default_mesh_is_one_rank():
    assert make_mesh_for_devices().shape == {"data": 1, "model": 1}


CPU_F32 = ["--device", "cpu", "--backend", "fused", "--mesh", "8", "8", "8", "--policy", "f32"]


@pytest.mark.parametrize("solver,problem", [("cg", "poisson"), ("pipelined_cg", "poisson"),
                                            ("pipelined_bicgstab", "convdiff")])
def test_cli_solver_picks_its_default_problem(solver, problem, capsys):
    """CG wants a symmetric operator: ``--solver cg``/``pipelined_cg`` default
    to poisson, the BiCGStab forms keep convdiff for star7."""
    res = solve.main(CPU_F32 + ["--solver", solver, "--tol", "1e-5"])
    assert (res["problem"], res["solver"]) == (problem, solver)
    assert res["converged"] and res["true_rel_residual"] < 1e-4
    assert f"solver={solver}" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["--precond", "chebyshev", "--problem", "poisson", "--cheb-degree", "4"],
    ["--precond", "jacobi", "--problem", "heterogeneous", "--maxiter", "2000"],
    ["--solver", "pipelined_bicgstab", "--precond", "jacobi", "--problem", "heterogeneous"],
    ["--solver", "cg", "--nrhs", "2"],
    ["--solver", "pipelined_bicgstab", "--nrhs", "2", "--precond", "chebyshev"],
], ids=["chebyshev", "jacobi", "pipelined_jacobi", "cg_nrhs", "pipelined_nrhs_chebyshev"])
def test_cli_cpu_paths_converge(extra):
    res = solve.main(CPU_F32 + extra)
    conv, true = res["converged"], res["true_rel_residual"]
    if isinstance(conv, list):
        conv, true = all(conv), max(true)
    assert conv and true < 1e-5, res


def test_cheb_degree_reaches_the_config(monkeypatch):
    seen = {}
    real = bicgstab.solve_distributed

    def spy(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)

    monkeypatch.setattr(bicgstab, "solve_distributed", spy)
    solve.main(CPU_F32 + ["--precond", "chebyshev", "--cheb-degree", "5", "--maxiter", "3"])
    assert seen["precond"] == PrecondConfig(name="chebyshev", degree=5)


@pytest.mark.parametrize("extra,msg", [
    (["--nrhs", "2"], "single-RHS"),
    (["--solver", "cg"], "does not honor"),
    (["--backend", "fused"], "does not honor"),
    (["--precond", "jacobi"], "does not honor"),
])
def test_refine_refuses_what_it_does_not_honor(extra, msg):
    with pytest.raises(SystemExit, match=msg):
        solve.main(["--device", "cpu", "--refine", *extra])


def test_refine_on_cpu(capsys):
    """``--refine`` (bf16_mixed inner solves by default): the printed true-
    residual trajectory falls at every outer step to below 1e-5."""
    res = solve.main(["--device", "cpu", "--refine", "--mesh", "8", "8", "8"])
    rels = res["refine_rel_residuals"]
    assert len(rels) == 5 and all(a > b for a, b in zip(rels, rels[1:])) and rels[-1] < 1e-5
    assert res["max_err"] < 1e-3
    printed = capsys.readouterr().out
    assert "refinement true-residual trajectory:" in printed
    assert "max err vs manufactured solution" in printed


@pytest.mark.parametrize("problem", ["heterogeneous", "random", "convdiff"])
def test_manufactured_system_draws_on_the_host(monkeypatch, problem):
    """Whatever the target device, the system and x_true come from CPU
    generators (one stream per seed on every device) and land on the
    target; ``meta`` stands in for a card here."""
    made = []
    real = torch.Generator

    class TorchSpy:
        """The torch module as the CLI's module sees it, recording each generator."""

        def __getattr__(self, name):
            return getattr(torch, name)

        def Generator(self, *args, **kw):  # noqa: N802
            gen = real(*args, **kw)
            made.append(gen.device)
            return gen

    monkeypatch.setattr(solve, "torch", TorchSpy())
    meta = torch.device("meta")
    _, cf, b = solve.manufactured_system(problem, stencil.STAR7, (4, 5, 6), seed=3,
                                         device=meta, nrhs=2)
    assert len(made) == 2 and all(d.type == "cpu" for d in made)
    assert b.device == meta and b.shape == (2, 4, 5, 6)
    assert all(t.device == meta for t in cf.diags.values())
    _, cpu_cf, cpu_b = solve.manufactured_system(problem, stencil.STAR7, (4, 5, 6), seed=3,
                                                 device=torch.device("cpu"), nrhs=2)
    want = torch.randn((2, 4, 5, 6), generator=real().manual_seed(4))
    assert torch.equal(solve.manufactured_solution((4, 5, 6), seed=3, device="cpu", nrhs=2),
                       want)
    assert torch.equal(cpu_b, stencil.rhs_for_solution(cpu_cf, want))


# --obs, --run-dir, --profile: the run bundle and the executed collective counts

def _bundle_events(run_dir):
    import json
    import os

    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("nrhs", ["1", "2"])
@pytest.mark.parametrize("separate", [False, True], ids=["fused", "separate"])
def test_cli_obs_bundle_counts_what_ran(tmp_path, nrhs, separate):
    """Each sync point's AllReduce is counted as it runs (the identity on one
    rank): 1 at setup + 3 per BiCGStab iteration, whatever the batch.  In the
    paper's separate schedule each dot is one AllReduce, the setup's two
    included: 2 + 5 per iteration (the JAX package's lowered program holds
    the same 2 + 5).  The bundle's solve event carries the printed
    iterations."""
    import os

    run_dir = str(tmp_path / "run")
    extra = ["--paper-separate-reductions"] if separate else []
    res = solve.main(CPU_F32 + ["--obs", "--run-dir", run_dir, "--nrhs", nrhs] + extra)
    assert res["run_dir"] == run_dir
    for name in ("manifest.json", "events.jsonl", "trace.json"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    events = _bundle_events(run_dir)
    (ev,) = [e for e in events if e["event"] == "solve"]
    iters = res["iterations"] if nrhs == "2" else [res["iterations"]]
    assert ev["iterations"] == iters and ev["n_rhs"] == int(nrhs)
    (col,) = [e for e in events if e["event"] == "collectives"]
    setup, per_iter = (2, 5) if separate else (1, 3)
    want = {"allreduce_total": setup + per_iter * max(iters), "ppermute_total": 0}
    assert {k: col[k] for k in want} == want == res["collectives"]


def test_cli_obs_changes_no_bits_and_records_the_spans(tmp_path, monkeypatch):
    import json

    xs = []
    real = bicgstab.solve_distributed

    def keep_x(*a, **kw):
        res = real(*a, **kw)
        xs.append(res.x.clone())
        return res

    monkeypatch.setattr(bicgstab, "solve_distributed", keep_x)
    plain = solve.main(CPU_F32)
    run_dir = tmp_path / "run"
    traced = solve.main(CPU_F32 + ["--obs", "--run-dir", str(run_dir)])
    assert torch.equal(xs[0], xs[1]) and plain["iterations"] == traced["iterations"]
    assert plain["collectives"] == traced["collectives"]
    names = {e["name"] for e in json.loads((run_dir / "trace.json").read_text())["traceEvents"]}
    assert {"solve.krylov", "operator.build", "comm.halo.issue", "comm.halo.interior"} <= names
    from repro_torch.obs import trace

    assert not trace.is_enabled()           # a later solve in the process pays nothing


def test_cli_profile_writes_a_torch_trace(tmp_path):
    import os

    run_dir = tmp_path / "run"
    res = solve.main(CPU_F32 + ["--profile", "--run-dir", str(run_dir), "--maxiter", "3"])
    assert res["run_dir"] == str(run_dir)
    assert os.path.getsize(run_dir / "torch_profile" / "torch_trace.json") > 0


def test_cli_profile_keeps_the_solves_own_error(tmp_path, monkeypatch):
    """A solve that raises under ``--profile`` raises its own error, not the
    profiler's "no device activity" check, which a run with no kernel fails."""
    from repro_torch.obs import trace

    real_start = solve.obs_manifest.start_run

    def start_run(*a, **kw):
        ctx = real_start(*a, **kw)
        ctx._profiler.cuda = True          # as on the card
        return ctx

    def run(args, device):
        raise ValueError("the solve's own error")

    monkeypatch.setattr(solve.obs_manifest, "start_run", start_run)
    monkeypatch.setattr(solve, "run", run)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(trace, "device_time_us", lambda prof: 0.0)
    with pytest.raises(ValueError, match="the solve's own error"):
        solve.main(CPU_F32 + ["--profile", "--run-dir", str(tmp_path / "run")])
    assert (tmp_path / "run" / "manifest.json").exists()


def test_cli_prints_collectives_and_roofline(capsys):
    res = solve.main(CPU_F32)
    printed = capsys.readouterr().out
    n = res["collectives"]["allreduce_total"]
    assert f"collectives (executed on one rank): allreduce={n} ppermute=0" in printed
    assert "of an H100's f32 peak (67 TFLOP/s, data sheet)" in printed and "on cpu" in printed
    assert 0 < res["roofline"]["fraction"] < 1


def test_cli_accepts_every_flag_of_the_reference():
    """Every option ``python -m repro.launch.solve`` declares, the port's
    parser declares too (read from the reference's source: its parser is
    built inside ``main``)."""
    import ast
    import os

    from _torch_port import REPO

    src = open(os.path.join(REPO, "src", "repro", "launch", "solve.py")).read()
    ref = {a.value for node in ast.walk(ast.parse(src)) if isinstance(node, ast.Call)
           and getattr(node.func, "attr", None) == "add_argument"
           for a in node.args if isinstance(a, ast.Constant) and str(a.value).startswith("--")}
    assert {"--autotune", "--obs", "--profile", "--run-dir", "--nrhs"} <= ref
    port = {opt for action in solve.build_parser()._actions for opt in action.option_strings}
    assert ref <= port, sorted(ref - port)
