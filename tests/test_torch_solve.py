"""The slice as a whole: the port's BiCGStab solve (reference, spmd and
fused backends, both schedules) against the JAX package's solves.

The systems are built by the JAX package and carried across with
``StencilCoeffs.from_numpy``; the right-hand sides are numpy arrays made
from a seed.  On these CPU tensors the fused backend's kernels take their
plain versions.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import assert_bitwise, carry_coeffs, run_python, to_np, to_t  # noqa: E402
from repro.core import bicgstab as jbi  # noqa: E402
from repro.core import stencil as jst  # noqa: E402
from repro_torch.core import bicgstab as tbi  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import stencil as tst  # noqa: E402
from repro_torch.core.operator import FusedOps, make_operator  # noqa: E402
from repro_torch.core.solvers import get_solver  # noqa: E402
from repro_torch.launch import solve as tsolve  # noqa: E402
from repro_torch.launch.mesh import RankMesh  # noqa: E402


def _system(shape, kind="convdiff", seed=0):
    if kind == "convdiff":
        cj = jst.convection_diffusion(shape)
    else:
        cj = jst.heterogeneous_poisson(jax.random.PRNGKey(seed), shape)
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
    bj = jst.rhs_for_solution(cj, jnp.asarray(x))
    return cj, carry_coeffs(cj), bj, to_t(bj)


def _rel(a, b) -> float:
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_fused_solve_matches_jax_pallas():
    """8x8x8 convdiff star7, f32, tol 1e-6: the same iteration count, x to rtol 1e-4."""
    cj, ct, bj, bt = _system((8, 8, 8))
    rj = jbi.solve_ref(cj, bj, tol=1e-6, maxiter=200, backend="pallas")
    rt = tbi.solve_ref(ct, bt, tol=1e-6, maxiter=200, backend="fused")
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(to_np(rt.x), to_np(rj.x), rtol=1e-4, atol=1e-5)


def test_spmd_solve_matches_jax_spmd():
    cj, ct, bj, bt = _system((16, 16, 8))
    rj = jbi.solve_ref(cj, bj, tol=1e-6, maxiter=300, backend="spmd")
    rt = tbi.solve_ref(ct, bt, tol=1e-6, maxiter=300, backend="spmd")
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(to_np(rt.x), to_np(rj.x), rtol=1e-4, atol=1e-5)


def test_port_backends_agree():
    """reference and spmd run the same arithmetic (bitwise); fused differs
    only in its dots' summation order (the same iteration count, x to 1e-5)."""
    _, ct, _, bt = _system((8, 8, 8))
    res = {be: tbi.solve_ref(ct, bt, tol=1e-6, maxiter=200, backend=be)
           for be in ("reference", "spmd", "fused")}
    assert_bitwise(res["reference"].x, res["spmd"].x)
    its = {be: int(r.iterations) for be, r in res.items()}
    assert len(set(its.values())) == 1, its
    assert _rel(res["fused"].x, res["spmd"].x) < 1e-5


def _with_spmd_dots(op):
    """The fused operator with every dot partial taken as the spmd backend
    takes it (``Policy.dot``): the kernels' vector outputs stay, only the
    dots' summation order changes."""
    d, f = op.policy.dot, op.fused

    def update_q_dots(alpha, r, s, y):
        q = f.update_q_dots(alpha, r, s, y)[0]
        return q, d(q, y), d(y, y)

    def update_xr_dots(alpha, omega, x, p, q, y, r0):
        x, r = f.update_xr_dots(alpha, omega, x, p, q, y, r0)[:2]
        return x, r, d(r0, r), d(r, r)

    return dataclasses.replace(op, fused=FusedOps(
        dot_partial=d, update_q_dots=update_q_dots, update_xr_dots=update_xr_dots,
        update_p=f.update_p))


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_differs_from_spmd_only_in_dot_order(seed):
    """The CLI's default f32 cell (48x48x32 convdiff star7, tol 1e-6): the
    fused path with its dots summed in the spmd backend's order is the spmd
    solve bit for bit, iteration count included.  What separates the two
    backends' iteration counts is the dots' summation order alone."""
    _, cf, b = tsolve.manufactured_system(None, tst.STAR7, (48, 48, 32), seed=seed,
                                          device=torch.device("cpu"))
    kw = dict(tol=1e-6, maxiter=200, policy=tprec.F32)
    bicgstab = get_solver("bicgstab")
    ref = bicgstab(make_operator("spmd", cf, policy=tprec.F32), b, None, **kw)
    var = bicgstab(_with_spmd_dots(make_operator("fused", cf, policy=tprec.F32)), b, None,
                   **kw)
    assert bool(ref.converged)
    assert int(var.iterations) == int(ref.iterations)
    assert_bitwise(var.x, ref.x)
    assert_bitwise(var.rel_residual, ref.rel_residual)


@pytest.mark.parametrize("backend", ["spmd", "fused"])
@pytest.mark.parametrize("policy", ["f32", "bf16_mixed"])
def test_blocking_equals_overlap_bitwise(backend, policy):
    _, ct, _, bt = _system((8, 6, 8))
    pol = tprec.get_policy(policy)
    rb, ro = (tbi.solve_ref(ct, bt, tol=1e-6, maxiter=60, backend=backend, policy=pol,
                            schedule=s) for s in ("blocking", "overlap"))
    assert int(rb.iterations) == int(ro.iterations)
    assert_bitwise(rb.x, ro.x)
    assert_bitwise(rb.rel_residual, ro.rel_residual)


def test_raw_diagonal_correction_heterogeneous():
    """A raw operator: the kernel applies the unit-diagonal family and the
    (d - 1) deviation is added outside it, as in the JAX pallas backend."""
    cj, ct, bj, bt = _system((8, 8, 8), kind="heterogeneous", seed=3)
    v = np.random.default_rng(9).standard_normal((8, 8, 8)).astype(np.float32)
    from repro.core.operator import make_operator as jmake

    uj = jmake("pallas", cj).apply(jnp.asarray(v))
    ut = make_operator("fused", ct).apply(to_t(v))
    np.testing.assert_allclose(to_np(ut), to_np(uj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(to_np(ut), to_np(jst.apply_ref(cj, jnp.asarray(v))),
                               rtol=1e-5, atol=1e-4)
    rj = jbi.solve_ref(cj, bj, tol=1e-5, maxiter=400, backend="pallas")
    rt = tbi.solve_ref(ct, bt, tol=1e-5, maxiter=400, backend="fused")
    assert bool(rt.converged)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 2
    # this operator is far less well conditioned than convdiff, so x itself
    # moves with the trajectory; hold the port's x to the JAX package's own
    # residual instead
    true_rel = np.linalg.norm(to_np(bj) - to_np(jst.apply_ref(cj, jnp.asarray(to_np(rt.x)))))
    assert true_rel / np.linalg.norm(to_np(bj)) < 2e-5


def test_record_history_matches_jax():
    """history[k] is the relative residual after iteration k+1, frozen
    after the exit, maxiter long."""
    cj, ct, bj, bt = _system((6, 6, 6))
    rj = jbi.solve_ref(cj, bj, tol=1e-5, maxiter=40, record_history=True)
    rt = tbi.solve_ref(ct, bt, tol=1e-5, maxiter=40, record_history=True)
    assert rt.history.shape == (40,)
    assert int(rt.iterations) == int(rj.iterations) < 40
    np.testing.assert_allclose(to_np(rt.history), to_np(rj.history), rtol=1e-3, atol=1e-7)
    assert float(rt.history[-1]) == float(rt.rel_residual)


def test_solve_distributed_one_rank():
    """solve_distributed on the 1x1 rank mesh is solve_ref bitwise; x0=None needs
    no setup SpMV and equals a zero warm start; more ranks than the process
    group holds (none here) raise."""
    _, ct, _, bt = _system((8, 8, 8))
    mesh = RankMesh(("data", "model"), (1, 1))
    kw = dict(tol=1e-6, maxiter=100, policy=tprec.F32, backend="fused")
    rd = tbi.solve_distributed(mesh, ct, bt, **kw)
    assert_bitwise(rd.x, tbi.solve_ref(ct, bt, **kw).x)
    assert_bitwise(rd.x, tbi.solve_distributed(mesh, ct, bt, torch.zeros_like(bt), **kw).x)
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        tbi.solve_distributed(RankMesh(("data", "model"), (2, 2)), ct, bt, **kw)


_STRICT_BF16 = """
import json, numpy as np, jax.numpy as jnp
from repro.core import bicgstab as jbi, precision as jprec, stencil as jst
from repro_torch.core import bicgstab as tbi, precision as tprec, stencil as tst
from repro_torch.device import tensor_from_numpy, tensor_to_numpy
shape = (8, 8, 8)
cj = jst.convection_diffusion(shape)
x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
bj = jst.rhs_for_solution(cj, jnp.asarray(x))
ct = tst.StencilCoeffs.from_numpy({n: np.asarray(a) for n, a in cj.diags.items()},
                                  device="cpu")
rj = jbi.solve_ref(cj, bj, tol=1e-3, maxiter=100, backend="pallas", policy=jprec.MIXED)
rt = tbi.solve_ref(ct, tensor_from_numpy(np.asarray(bj)), tol=1e-3, maxiter=100,
                   backend="fused", policy=tprec.MIXED)
xj = np.asarray(rj.x.astype(jnp.float32), np.float64)
xt = tensor_to_numpy(rt.x).astype(np.float64)
print(json.dumps({"it_j": int(rj.iterations), "it_t": int(rt.iterations),
                  "conv_t": bool(rt.converged),
                  "rel": float(np.linalg.norm(xt - xj) / np.linalg.norm(xj))}))
"""


def test_bf16_mixed_solve_strict_precision_subprocess():
    """bf16_mixed through the fused path against JAX pallas with
    ``--xla_allow_excess_precision=false``: iterations within 1, x within
    2e-2 relative (the dots' summation order moves the bf16 trajectory)."""
    out = run_python(_STRICT_BF16, env_extra={
        "XLA_FLAGS": "--xla_allow_excess_precision=false", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["conv_t"], res
    assert abs(res["it_j"] - res["it_t"]) <= 1, res
    assert res["rel"] <= 2e-2, res
