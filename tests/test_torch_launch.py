"""The port's entry point: ``python -m repro_torch.launch.solve``, its device
rule, and the kernel launch counters on CPU tensors."""

import pytest

torch = pytest.importorskip("torch")

from _torch_port import run_module  # noqa: E402
from repro_torch.core import bicgstab, precision, stencil  # noqa: E402
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
