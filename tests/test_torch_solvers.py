"""The port's CG and pipelined solvers against the JAX package's, and the
port's own invariants (pipelined tracks generic, B = 1 is unbatched, each
RHS of a block is its solo solve, zero RHS, warm start).

Systems are built by the JAX package and carried across; right-hand sides
are numpy arrays made from a seed.  The port's ``fused`` backend takes its
kernels' plain versions on these CPU tensors; the JAX ``pallas`` backend
runs in interpret mode on 8x8x8 blocks only.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import assert_bitwise, carry_coeffs, to_np, to_t  # noqa: E402
from repro.core import bicgstab as jbi  # noqa: E402
from repro.core import stencil as jst  # noqa: E402
from repro_torch.core import bicgstab as tbi  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core.solvers import SOLVERS  # noqa: E402

SOLVER_NAMES = ("bicgstab", "cg", "pipelined_bicgstab", "pipelined_cg")
#: pipelined CG keeps w = A r by recurrence: its f32 floor is near 1e-5
TOL = {"pipelined_cg": 1e-5}
#: CG wants a symmetric operator; BiCGStab's pipelined form gets convdiff
PROBLEM = {"cg": "poisson", "pipelined_cg": "poisson", "bicgstab": "convdiff",
           "pipelined_bicgstab": "convdiff"}


def _system(shape, problem, seed=1, nrhs=None):
    """(JAX coeffs, port coeffs, JAX b, port b, x_true) with x_true from numpy."""
    cj = jst.poisson(shape) if problem == "poisson" else jst.convection_diffusion(shape)
    xshape = shape if nrhs is None else (nrhs,) + shape
    x = np.random.default_rng(seed).standard_normal(xshape).astype(np.float32)
    bj = jst.rhs_for_solution(cj, jnp.asarray(x))
    return cj, carry_coeffs(cj), bj, to_t(bj), x


def _solve(ct, bt, solver, **kw):
    kw = dict(dict(tol=TOL.get(solver, 1e-6), maxiter=100, policy=tprec.F32), **kw)
    return tbi.solve_ref(ct, bt, solver=solver, **kw)


def test_registry_has_every_solver():
    assert set(SOLVERS) == set(SOLVER_NAMES)


@pytest.mark.parametrize("backends", [("reference", "reference"), ("spmd", "spmd"),
                                      ("fused", "pallas")], ids=lambda b: b[0])
@pytest.mark.parametrize("solver", ["cg", "pipelined_cg", "pipelined_bicgstab"])
def test_solver_matches_jax(solver, backends):
    """8x8x8, f32: the same system through the port's backend and its JAX
    counterpart.  Iteration counts within 2, x within 2e-4, and the
    recorded histories within rtol 5e-2 over their common prefix (f32
    summation order and XLA's FMA contraction move both by rounding)."""
    tb, jb = backends
    cj, ct, bj, bt, _ = _system((8, 8, 8), PROBLEM[solver])
    tol = TOL.get(solver, 1e-6)
    rj = jbi.solve_ref(cj, bj, tol=tol, maxiter=100, solver=solver, backend=jb,
                       record_history=True)
    rt = _solve(ct, bt, solver, backend=tb, record_history=True)
    assert bool(rt.converged) and bool(rj.converged) and not bool(rt.breakdown)
    it_t, it_j = int(rt.iterations), int(rj.iterations)
    assert abs(it_t - it_j) <= 2, (it_t, it_j)
    assert np.abs(to_np(rt.x) - to_np(rj.x)).max() <= 2e-4
    n = min(it_t, it_j) - 1
    np.testing.assert_allclose(to_np(rt.history)[:n], to_np(rj.history)[:n], rtol=5e-2,
                               atol=1e-8)
    assert rt.history.shape == (100,)
    assert float(rt.history[-1]) == float(rt.rel_residual)


@pytest.mark.parametrize("backend", ["spmd", "fused"])
@pytest.mark.parametrize("pipelined,generic", [("pipelined_bicgstab", "bicgstab"),
                                               ("pipelined_cg", "cg")])
def test_pipelined_tracks_generic(pipelined, generic, backend):
    """The pipelined solver reproduces its generic counterpart's residual
    trajectory (history[k] is the residual after iteration k+1 for both),
    needs at most 2 iterations more and solves the system."""
    _, ct, _, bt, x = _system((8, 8, 8), PROBLEM[pipelined], seed=2)
    tol = TOL.get(pipelined, 1e-6)
    g = _solve(ct, bt, generic, tol=tol, backend=backend, record_history=True)
    p = _solve(ct, bt, pipelined, tol=tol, backend=backend, record_history=True)
    assert bool(p.converged) and not bool(p.breakdown)
    assert int(p.iterations) <= int(g.iterations) + 2
    n = min(int(g.iterations), int(p.iterations) - 1, 15)
    np.testing.assert_allclose(to_np(p.history)[:n], to_np(g.history)[:n], rtol=5e-2,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(p.x), x, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("solver", SOLVER_NAMES)
def test_batch_of_one_is_unbatched_bitwise(solver):
    """A (1,)+shape solve is the unbatched solve bit for bit, history too."""
    _, ct, _, bt, _ = _system((8, 8, 6), PROBLEM[solver])
    ru = _solve(ct, bt, solver, backend="fused", record_history=True, maxiter=60)
    rb = _solve(ct, bt[None], solver, backend="fused", record_history=True, maxiter=60)
    assert rb.x.shape == (1, 8, 8, 6) and rb.history.shape == (60, 1)
    assert_bitwise(rb.x[0], ru.x)
    assert int(rb.iterations[0]) == int(ru.iterations)
    assert bool(rb.converged[0]) == bool(ru.converged)
    assert_bitwise(rb.rel_residual[0], ru.rel_residual)
    assert_bitwise(rb.history[:, 0], ru.history)


@pytest.mark.parametrize("solver", SOLVER_NAMES)
def test_each_rhs_is_its_solo_solve_bitwise(solver):
    """Each RHS of a B = 3 block solve reproduces its solo solve exactly:
    iterations, x and residual (a stopped RHS stays frozen while the others
    iterate on)."""
    _, ct, _, bt, _ = _system((8, 8, 6), PROBLEM[solver], seed=3, nrhs=3)
    rb = _solve(ct, bt, solver, backend="fused", maxiter=80)
    assert len(set(rb.iterations.tolist())) > 1     # some RHS stop before others
    for i in range(3):
        ri = _solve(ct, bt[i], solver, backend="fused", maxiter=80)
        assert int(rb.iterations[i]) == int(ri.iterations)
        assert_bitwise(rb.x[i], ri.x)
        assert_bitwise(rb.rel_residual[i], ri.rel_residual)
    assert bool(rb.converged.all())


@pytest.mark.parametrize("solver", SOLVER_NAMES)
def test_zero_rhs_converges_at_once(solver):
    """b = 0: no iteration, x = 0, converged; in a block, the zero RHS stays
    at 0 iterations while the other iterates."""
    _, ct, _, bt, _ = _system((6, 6, 6), PROBLEM[solver])
    r0 = _solve(ct, torch.zeros_like(bt), solver, backend="fused")
    assert int(r0.iterations) == 0 and bool(r0.converged) and not bool(r0.breakdown)
    assert not to_np(r0.x).any()
    rb = _solve(ct, torch.stack([torch.zeros_like(bt), bt]), solver, backend="fused")
    assert int(rb.iterations[0]) == 0 and int(rb.iterations[1]) > 0
    assert not to_np(rb.x[0]).any() and bool(rb.converged.all())


@pytest.mark.parametrize("solver", ["cg", "pipelined_cg", "pipelined_bicgstab"])
def test_warm_start_cuts_iterations(solver):
    """A guess near the solution needs fewer iterations and ends at it."""
    _, ct, _, bt, x = _system((8, 8, 8), PROBLEM[solver])
    cold = _solve(ct, bt, solver, backend="fused")
    near = torch.from_numpy(x + 1e-3 * np.ones_like(x))
    warm = _solve(ct, bt, solver, backend="fused", x0=near)
    assert bool(warm.converged)
    assert int(warm.iterations) < int(cold.iterations)
    np.testing.assert_allclose(to_np(warm.x), x, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("solver,precond", [("pipelined_bicgstab", "jacobi"),
                                            ("pipelined_cg", "chebyshev")])
def test_pipelined_solvers_accept_preconditioning(solver, precond):
    """Right preconditioning wraps the pipelined loops like the generic
    ones (Jacobi on the raw heterogeneous operator, Chebyshev on Poisson)."""
    import jax

    shape = (6, 6, 8)
    cj = (jst.heterogeneous_poisson(jax.random.PRNGKey(3), shape) if precond == "jacobi"
          else jst.poisson(shape))
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    bt = to_t(jst.rhs_for_solution(cj, jnp.asarray(x)))
    res = _solve(carry_coeffs(cj), bt, solver, tol=1e-5, maxiter=400, backend="fused",
                 precond=precond)
    assert bool(res.converged), solver
    np.testing.assert_allclose(to_np(res.x), x, rtol=2e-3, atol=2e-3)


#: each path's kernel calls over ``n`` fused iterations from x0 = None, the
#: setup's 2 dots included: (solver, problem, precond, (K1, K5, each of K2-K4)).
#: Chebyshev of degree 3 costs 3 stencils per wrapped SpMV and 2 at the unwrap.
KERNEL_CALLS = {
    "cg": ("cg", "poisson", "none", lambda n: (n, 2 * n + 2, 0)),
    "pipelined_cg": ("pipelined_cg", "poisson", "none", lambda n: (n + 1, 2 * n + 2, 0)),
    "pipelined_bicgstab": ("pipelined_bicgstab", "convdiff", "none",
                           lambda n: (2 * n + 2, 12 * n + 2, 0)),
    "chebyshev": ("bicgstab", "poisson", "chebyshev", lambda n: (6 * n + 2, n + 2, n)),
    "jacobi": ("bicgstab", "heterogeneous", "jacobi", lambda n: (2 * n, n + 2, n)),
}


@pytest.mark.parametrize("nrhs", [None, 2], ids=["unbatched", "batched"])
@pytest.mark.parametrize("label", sorted(KERNEL_CALLS))
def test_fused_paths_call_each_kernel_as_counted(monkeypatch, label, nrhs):
    """The kernel wrappers each fused path calls per iteration, counted on
    the CPU (where they take their plain versions): the numbers the card's
    launch counters must read."""
    import jax

    from repro_torch.kernels.fused_iter import kernel as fk
    from repro_torch.kernels.stencil_nd import ops as sops

    calls = collections.Counter()

    def count(module, name):
        real = getattr(module, name)

        def wrapper(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)

        monkeypatch.setattr(module, name, wrapper)

    for name in ("stencil_nd", "stencil_nd_batched"):
        count(sops, name)
    for name in fk.launches:
        count(fk, name)
    solver, problem, precond, formula = KERNEL_CALLS[label]
    shape = (6, 6, 6)
    cj = (jst.heterogeneous_poisson(jax.random.PRNGKey(3), shape) if problem == "heterogeneous"
          else _system(shape, problem)[0])
    xshape = shape if nrhs is None else (nrhs,) + shape
    x = np.random.default_rng(5).standard_normal(xshape).astype(np.float32)
    bt = to_t(jst.rhs_for_solution(cj, jnp.asarray(x)))
    n = 4
    res = _solve(carry_coeffs(cj), bt, solver, tol=0.0, maxiter=n, backend="fused",
                 precond=precond)
    assert res.iterations.tolist() == ([n] * nrhs if nrhs else n)
    k1, k5, passes = formula(n)
    sfx = "" if nrhs is None else "_batched"
    want = {"stencil_nd" + sfx: k1, "dot_mixed" + sfx: k5}
    want.update({name + sfx: passes for name in ("update_q_dots", "update_xr_dots", "update_p")})
    assert calls == collections.Counter({k: v for k, v in want.items() if v}), calls


def test_bf16_pipelined_cg_drifts_as_jax():
    """bf16_mixed, 32x32x24 Poisson, 30 iterations at tol 0: pipelined CG
    keeps w = A r by recurrence, so its x drifts far from its recurrence
    residual, in the port as in the JAX package: each true residual is
    above 10x its CG's, and the two within a factor 3 of each other."""
    from repro.core import precision as jprec

    shape = (32, 32, 24)
    cj, ct, bj, bt, _ = _system(shape, "poisson")
    true = {}
    for solver in ("cg", "pipelined_cg"):
        rj = jbi.solve_ref(cj, bj.astype(jnp.bfloat16), tol=0.0, maxiter=30, solver=solver,
                           backend="spmd", policy=jprec.MIXED)
        rt = tbi.solve_ref(ct, bt.to(torch.bfloat16), tol=0.0, maxiter=30, solver=solver,
                           backend="fused", policy=tprec.MIXED)
        for side, x in (("jax", to_np(rj.x)), ("port", to_np(rt.x))):
            r = to_np(bj).astype(np.float64) - to_np(
                jst.apply_ref(cj, jnp.asarray(x, jnp.float32))).astype(np.float64)
            true[side, solver] = np.linalg.norm(r) / np.linalg.norm(to_np(bj))
    for side in ("jax", "port"):
        assert true[side, "pipelined_cg"] > 10 * true[side, "cg"], true
    assert 1 / 3 < true["port", "pipelined_cg"] / true["jax", "pipelined_cg"] < 3, true
