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
