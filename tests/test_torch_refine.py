"""The port's solve entry points beyond the plain solve (``core/bicgstab.py``):
iterative refinement, the standalone iteration, ``global_apply`` and
``cg_ref``, against the JAX package's and against the port's own loops.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import assert_bitwise, carry_coeffs, to_np, to_t  # noqa: E402
from repro.core import bicgstab as jbi  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.core import stencil as jst  # noqa: E402
from repro.launch.mesh import make_mesh_for_devices as jmesh  # noqa: E402
from repro_torch.core import bicgstab as tbi  # noqa: E402
from repro_torch.core import halo as thalo  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import stencil as tst  # noqa: E402
from repro_torch.core.operator import make_operator  # noqa: E402
from repro_torch.core.solvers import bicgstab as tsb  # noqa: E402
from repro_torch.launch.mesh import RankMesh  # noqa: E402

ONE_RANK = RankMesh(("data", "model"), (1, 1))
TWO_BY_TWO = RankMesh(("data", "model"), (2, 2))


def _convdiff(shape, seed=1):
    cj = jst.convection_diffusion(shape)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return cj, carry_coeffs(cj), x


def test_solve_refined_matches_jax():
    """6x6x6 convdiff, bf16_mixed inner solves: the f32 true residual falls
    at every outer step and ends below 1e-5; x within 1e-3 of the JAX
    package's refined solution.  On the one-rank mesh (spmd inner solves,
    ``global_apply``) the result is the meshless one (reference backend) bit
    for bit."""
    cj, ct, x = _convdiff((6, 6, 6))
    bj = jst.rhs_for_solution(cj, jnp.asarray(x))
    xj, rels_j = jbi.solve_refined(cj, bj, outer_iters=4, inner_maxiter=60,
                                   inner_policy=jprec.MIXED)
    xt, rels = tbi.solve_refined(ct, to_t(bj), outer_iters=4, inner_maxiter=60,
                                 inner_policy=tprec.MIXED)
    rels = to_np(rels)
    assert rels.shape == (5,) and xt.dtype == torch.float32
    assert (np.diff(np.log10(rels + 1e-30)) < 0).all(), rels
    assert rels[-1] < 1e-5
    assert np.abs(to_np(xt) - to_np(xj)).max() <= 1e-3
    assert np.abs(to_np(xt) - x).max() <= 1e-3
    np.testing.assert_allclose(rels, to_np(rels_j), rtol=0.5, atol=1e-6)
    xm, rels_m = tbi.solve_refined(ct, to_t(bj), mesh=ONE_RANK, outer_iters=4,
                                   inner_maxiter=60, inner_policy=tprec.MIXED)
    assert_bitwise(xm, xt)
    assert_bitwise(rels_m, rels)


def _first_loop_step(monkeypatch, loop):
    """(init carry, carry after one step) of a BiCGStab loop run to
    ``maxiter=1``, read by wrapping its ``run_krylov``."""
    seen = {}
    real = tsb.run_krylov

    def spy(step, init, **kw):
        seen["init"], seen["step"] = init, step(init)
        return real(step, init, **kw)

    monkeypatch.setattr(tsb, "run_krylov", spy)
    loop()
    return seen["init"], seen["step"]


@pytest.mark.parametrize("policy", ["f32", "bf16_mixed"])
@pytest.mark.parametrize("backend", ["fused", "spmd"])
def test_iteration_fn_is_the_loops_first_step(monkeypatch, backend, policy):
    """``make_iteration_fn`` called on the solve's initial state gives the
    loop's first step bit for bit in all five outputs (fused: the fused
    loop; spmd: the generic loop)."""
    pol = tprec.get_policy(policy)
    _, ct, x = _convdiff((8, 6, 8))
    b = tst.rhs_for_solution(ct, torch.from_numpy(x)).to(pol.storage)
    op = make_operator(backend, ct, policy=pol)
    kw = dict(tol=0.0, maxiter=1, policy=pol)
    if backend == "fused":
        init, step = _first_loop_step(monkeypatch, lambda: tsb.bicgstab_fused_loop(
            op, b, None, **kw))
    else:
        init, step = _first_loop_step(monkeypatch, lambda: tsb.bicgstab_loop(
            op.apply, op.dots, b, None, **kw))
    _, x0, r0, p0, rho0, *_ = init
    out = tbi.make_iteration_fn(ONE_RANK, policy=pol, backend=backend)(
        op.coeffs, x0, r0, p0, r0, rho0)
    assert len(out) == 5
    for got, want in zip(out, step[1:6]):
        assert_bitwise(got, want)


@pytest.mark.parametrize("backends", [("fused", "pallas"), ("spmd", "spmd")],
                         ids=lambda b: b[0])
def test_iteration_fn_matches_jax(backends):
    """One f32 iteration on 8x8x8 convdiff from the same numpy state,
    through the port and the JAX package on a one-device mesh: vectors
    within 1e-5 of their largest entry, rho and res2 within 1e-5 relative."""
    tb, jb = backends
    cj, ct, _ = _convdiff((8, 8, 8))
    rng = np.random.default_rng(7)
    x, r, p, r0 = (rng.standard_normal((8, 8, 8)).astype(np.float32) for _ in range(4))
    rho = np.float32(np.dot(r0.ravel(), r.ravel()))
    out_j = jbi.make_iteration_fn(jmesh(), policy=jprec.F32, backend=jb)(
        cj, *(jnp.asarray(a) for a in (x, r, p, r0)), jnp.float32(rho))
    out_t = tbi.make_iteration_fn(ONE_RANK, policy=tprec.F32, backend=tb)(
        ct, *(torch.from_numpy(a) for a in (x, r, p, r0)), torch.tensor(rho))
    for got, want in zip(out_t, out_j):
        got, want = to_np(got), to_np(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)


def test_iteration_fn_refuses_more_ranks():
    """More ranks than the process group holds (none here) are refused, and
    the reference backend is refused on any fabric of more ranks."""
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        tbi.make_iteration_fn(TWO_BY_TWO, backend="fused")
    with pytest.raises(ValueError, match="single-address-space"):
        tbi.make_iteration_fn(TWO_BY_TWO, backend="reference")


def test_global_apply_on_one_rank():
    """The one-rank global SpMV is the local apply on the whole array (and
    the reference apply bit for bit); more ranks than the process group
    holds (none here) raise."""
    _, ct, x = _convdiff((6, 5, 4))
    v = torch.from_numpy(x)
    assert_bitwise(thalo.global_apply(ONE_RANK, ct, v), tst.apply_ref(ct, v))
    vb = torch.stack([v, 2 * v])
    assert_bitwise(thalo.global_apply(ONE_RANK, ct, vb, schedule="blocking"),
                   tst.apply_ref(ct, vb))
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        thalo.global_apply(TWO_BY_TWO, ct, v)


def test_cg_ref_is_a_cg_solve():
    cj = jst.poisson((6, 6, 6))
    ct = carry_coeffs(cj)
    b = tst.rhs_for_solution(ct, torch.from_numpy(
        np.random.default_rng(2).standard_normal((6, 6, 6)).astype(np.float32)))
    res = tbi.cg_ref(ct, b, tol=1e-6, x0=torch.ones_like(b))
    want = tbi.solve_ref(ct, b, tol=1e-6, solver="cg")
    assert bool(res.converged) and int(res.iterations) == int(want.iterations)
    assert_bitwise(res.x, want.x)
