"""The port's steady SIMPLE drivers against the JAX package's, at the
reference's own test sizes: the n=24 lid-driven cavity of
``tests/test_cfd.py`` through both packages, and the port's own checks of
the converged field (Ghia centerline bands, divergence, no-slip walls,
Stokes symmetry).  Tolerances are stated per test."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.apps.cfd as J  # noqa: E402
import repro_torch.apps.cfd as T  # noqa: E402
from _torch_port import to_np  # noqa: E402
from repro.launch.cfd import ghia_check as jax_ghia_check  # noqa: E402
from repro.launch.mesh import make_mesh_for_devices as jax_mesh  # noqa: E402
from repro_torch.launch.cfd import ghia_check  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402


@pytest.fixture(scope="module")
def cavities():
    """The n=24, Re=100 cavity (250 outer iterations at most, tol 5e-6)
    through both packages, spmd backend on a one-rank fabric."""
    kw = dict(n=24, reynolds=100.0, outer_iters=250, tol=5e-6)
    ref = J.solve_cavity(J.CavityConfig(**kw), J.SolverOptions(backend="spmd"), jax_mesh(1))
    port = T.solve_cavity(T.CavityConfig(**kw), T.SolverOptions(backend="spmd"),
                          make_mesh_for_devices(1), device="cpu")
    return kw, ref, port


def test_both_converge_in_as_many_outer_iterations(cavities):
    """Both reach tol; outer-iteration counts within 5% of each other."""
    kw, (*_, jh), (*_, th) = cavities
    assert jh[-1] < kw["tol"] and th[-1] < kw["tol"]
    assert th[-1] < th[0] / 100
    assert abs(len(th) - len(jh)) <= 0.05 * len(jh), (len(th), len(jh))


def test_centerlines_agree(cavities):
    """The vertical centerline u profiles within 1e-3 of each other."""
    _, (ju, *_), (tu, *_) = cavities
    np.testing.assert_allclose(to_np(T.centerline_u(tu)), np.asarray(J.centerline_u(ju)),
                               rtol=0, atol=1e-3)


def test_port_passes_ghia_divergence_and_no_slip(cavities):
    """The port's converged field alone: the Ghia Re=100 bands, a
    divergence-free field to 1e-4 (``tests/test_cfd.py``'s bound), and wall
    faces exactly zero."""
    kw, _, (u, v, p, hist) = cavities
    ok, report = ghia_check(u)
    assert ok, report
    h = 1.0 / kw["n"]
    div = (u[1:, :] - u[:-1, :] + v[:, 1:] - v[:, :-1]) * h
    assert float(div.abs().max()) < 1e-4
    for wall in (u[0, :], u[-1, :], v[:, 0], v[:, -1]):
        assert float(wall.abs().max()) == 0.0
    assert torch.isfinite(p).all()


def test_ghia_check_gives_the_references_verdict(cavities):
    """On the same centerlines, passing and failing, the port's check
    prints the reference's report."""
    _, (ju, *_), (tu, *_) = cavities
    fields = [tu]
    for col, val in ((slice(None), 0.0), (-1, 0.1), (0, 0.5)):   # break one band each
        bad = tu.clone()
        bad[bad.shape[0] // 2, col] = val
        fields.append(bad)
    verdicts = []
    for f in fields:
        port = ghia_check(f)
        assert port == jax_ghia_check(np.asarray(to_np(f)))
        verdicts.append(port[0])
    assert verdicts == [True, False, False, False]


def test_stokes_flow_symmetry():
    """At Re -> 0 the cavity flow is left-right antisymmetric in u
    (``tests/test_cfd.py``'s check and tolerance, on the port)."""
    cfg = T.CavityConfig(n=16, reynolds=0.5, outer_iters=150, tol=1e-6)
    u, v, p, hist = T.solve_cavity(cfg, device="cpu")
    un = to_np(u)
    np.testing.assert_allclose(un, un[::-1, :], atol=2e-3)


def test_raw_rows_with_jacobi_converge_to_same_flow():
    """``normalize=False`` hands the solver the raw aP rows and Jacobi does
    the normalization; the flow converges to the same field within 2e-3,
    the reference's bound (``tests/test_apps_cfd.py``)."""
    cfg = T.CFDConfig(n=12, reynolds=100.0, outer_iters=120, tol=1e-5)
    u0, v0, p0, h0 = T.solve_steady(cfg, T.SolverOptions(), device="cpu")
    u1, v1, p1, h1 = T.solve_steady(cfg, T.SolverOptions(precond="jacobi", normalize=False),
                                    device="cpu")
    assert h0[-1] < cfg.tol and h1[-1] < cfg.tol
    np.testing.assert_allclose(to_np(u0), to_np(u1), atol=2e-3)


def test_pipelined_pressure_solve_drives_continuity_down():
    """The pipelined solver on the pressure system (the reference's check)
    and the same run's field against the reference's within 1e-3."""
    cfg = dict(n=12, reynolds=100.0, outer_iters=30, tol=1e-12)
    opts = dict(backend="reference", p_solver="pipelined_bicgstab")
    u, v, p, hist = T.solve_steady(T.CFDConfig(**cfg), T.SolverOptions(**opts), device="cpu")
    assert hist[-1] < hist[0] * 0.2
    ju, jv, jp, jhist = J.solve_steady(J.CFDConfig(**cfg), J.SolverOptions(**opts))
    np.testing.assert_allclose(to_np(u), np.asarray(ju), rtol=1e-3, atol=1e-3)


def test_schedules_agree_bitwise():
    """On one rank the blocking and overlap schedules run the same ops:
    the whole steady run is the same, bit for bit."""
    cfg = T.CFDConfig(n=12, outer_iters=10, tol=0.0)
    runs = [T.solve_steady(cfg, T.SolverOptions(backend="spmd", schedule=s), device="cpu")
            for s in ("blocking", "overlap")]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    assert runs[0][3] == runs[1][3]


def test_bf16_cavity_stays_finite():
    """At bf16_mixed the truncated pressure solve can diverge (a recurrence
    residual above 1); applied as a correction, that blows the outer loop
    up: without its guard the port, like the reference's op-by-op loop bit
    for bit, left 1 by outer 20 at n=24 and overflowed.  The driver keeps a
    diverged solve's warm start, and the run stays bounded."""
    from repro_torch.core import precision

    cfg = T.CFDConfig(n=24, outer_iters=30, tol=0.0, policy=precision.MIXED)
    u, v, p, hist = T.solve_steady(cfg, T.SolverOptions(backend="spmd"), device="cpu")
    assert len(hist) == 30 and max(hist) < 0.02
    assert all(bool(torch.isfinite(f).all()) for f in (u, v, p))


def test_a_diverged_inner_solve_keeps_its_warm_start(monkeypatch):
    from repro_torch.apps.cfd import driver
    from repro_torch.core.solvers.common import SolveResult

    def diverging(op, b, x0=None, **kw):
        return SolveResult(x=x0 + 1e6, iterations=torch.tensor(5), converged=torch.tensor(False),
                           rel_residual=torch.tensor(3.0), breakdown=torch.tensor(False))

    monkeypatch.setattr(driver, "get_solver", lambda name: diverging)
    cfg = T.CFDConfig(n=8)
    rows = tuple(torch.ones(8, 8) for _ in range(5))
    x0 = torch.full((8, 8), 0.25)
    opts = T.SolverOptions()
    x = driver._inner_solve(cfg, opts, opts.precond_config(), driver.FabricAxes(), rows,
                            torch.ones(8, 8), x0, 5)
    assert torch.equal(x, x0)
