"""Port parity for the 7-point SpMV with its dot epilogue (K6): the plain
version behind ``repro_torch.kernels.stencil_nd.fused`` against the JAX
package's ``stencil7_dot``/``stencil7_two_dots`` Pallas kernel in interpret
mode, and ``solve_ref_fused`` against the JAX one.

Tolerances (tightened from ``tests/test_kernels.py``'s rtol 1e-5 / 1e-4):

* the vector: f32 within 6 ulp of each point's largest term, one per term
  (XLA may contract each of the six multiply-adds into an FMA, the port
  never does); bf16 bitwise (a bf16 product is exact in f32, so a
  contracted FMA rounds the same);
* the dots: rtol 1e-5 (the same f32 terms, summed in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import assert_bitwise, assert_ulp_close, carry_coeffs, to_np, to_t  # noqa: E402
from repro.core import bicgstab as jbi  # noqa: E402
from repro.core import stencil as jst  # noqa: E402
from repro.kernels.stencil_nd import fused as jfused  # noqa: E402
from repro_torch.core import bicgstab as tbi  # noqa: E402
from repro_torch.core import stencil as tst  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.stencil_nd import fused as tfused  # noqa: E402
from repro_torch.kernels.stencil_nd.ref import (  # noqa: E402
    stencil7_dots_padded_ref,
    stencil_nd_padded_ref,
)

SHAPES = [(4, 4, 8), (5, 6, 16), (3, 3, 4)]
_J = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """CPU tensors take the plain version: no kernel launch is counted."""
    reset_launch_counts()
    yield
    assert not any(launch_counts().values()), launch_counts()


def _inputs(shape, dtype, seed=0):
    """A random star7 system and two vectors, in ``dtype``, for both packages."""
    cf = jst.random_nonsymmetric(jax.random.PRNGKey(seed), shape)
    cf = jst.StencilCoeffs({n: a.astype(_J[dtype]) for n, a in cf.diags.items()})
    rng = np.random.default_rng(seed + 1)
    p, w = (jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(_J[dtype])
            for _ in range(2))
    return cf, carry_coeffs(cf), p, w


def _check_vec(got, want, cf, p, dtype):
    if dtype == "bf16":
        assert_bitwise(got, want)
        return
    vp = np.pad(to_np(p).astype(np.float64), 1)
    n = p.shape
    win = lambda off: vp[tuple(slice(1 + o, 1 + o + k) for o, k in zip(off, n))]
    scale = np.abs(win((0, 0, 0))) + sum(
        np.abs(to_np(cf.diags[name]) * win(off)) for name, off in zip(jst.STAR7.names,
                                                                       jst.STAR7.offsets))
    assert_ulp_close(got, want, scale, n_ulp=6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stencil7_dot_matches_jax(shape, dtype):
    cj, ct, p, r0 = _inputs(shape, dtype)
    s, r0s = jfused.stencil7_dot(cj, p, r0)
    ts, tr0s = tfused.stencil7_dot(ct, to_t(p), to_t(r0))
    assert ts.dtype == to_t(p).dtype and tuple(ts.shape) == shape
    _check_vec(ts, s, cj, p, dtype)
    np.testing.assert_allclose(float(tr0s), float(r0s), rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stencil7_two_dots_matches_jax(shape, dtype):
    cj, ct, q, _ = _inputs(shape, dtype, seed=3)
    y, qy, yy = jfused.stencil7_two_dots(cj, q)
    ty, tqy, tyy = tfused.stencil7_two_dots(ct, to_t(q))
    _check_vec(ty, y, cj, q, dtype)
    np.testing.assert_allclose(float(tqy), float(qy), rtol=1e-5)
    np.testing.assert_allclose(float(tyy), float(yy), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vector_equals_k1_with_f32_accumulation(dtype):
    """The SpMV's terms come in STAR7's canonical order, so with f32
    accumulation its vector is the stencil kernel's bit for bit; the dots
    come from the unrounded f32 accumulator, not the stored vector."""
    _, ct, q, _ = _inputs((5, 6, 7), dtype, seed=5)
    q = to_t(q)
    y, qy, yy = tfused.stencil7_two_dots(ct, q)
    cfs = [ct.diags[n] for n in tst.STAR7.names]
    vp = torch.nn.functional.pad(q, (1, 1) * 3)
    assert_bitwise(y, stencil_nd_padded_ref(vp, cfs, tst.STAR7.offsets, radius=1))
    acc = vp[1:-1, 1:-1, 1:-1].float()
    for c, off in zip(cfs, tst.STAR7.offsets):
        acc = acc + c.float() * vp[tuple(slice(1 + o, 1 + o + n)
                                         for o, n in zip(off, q.shape))].float()
    assert_bitwise(yy, (acc * acc).sum())
    assert_bitwise(qy, (q.float() * acc).sum())


@pytest.mark.parametrize("two_dots", [False, True])
@pytest.mark.parametrize("accum", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_w_none_is_the_interior_of_vp(dtype, accum, two_dots):
    """``w=None`` (the kernel takes w from its ring) gives the bits of the
    same w passed as a contiguous tensor, at every storage and accumulation
    dtype, through the plain version and, for the two-dot variant that
    takes it, the wrapper's CPU path."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    rng = np.random.default_rng(11)
    shape = (5, 6, 7)
    vp = torch.from_numpy(rng.standard_normal(tuple(s + 2 for s in shape)).astype(np.float32))
    vp = vp.to(tdt[dtype])
    cfs = [torch.from_numpy(0.2 * rng.standard_normal(shape).astype(np.float32)).to(tdt[dtype])
           for _ in range(6)]
    inner = vp[1:-1, 1:-1, 1:-1].contiguous()
    kw = dict(two_dots=two_dots, accum_dtype=tdt[accum])
    want = stencil7_dots_padded_ref(vp, inner, cfs, tst.STAR7.offsets, **kw)
    gots = [stencil7_dots_padded_ref(vp, None, cfs, tst.STAR7.offsets, **kw)]
    if two_dots:
        gots.append(tfused.stencil7_dots_padded(vp, None, cfs, **kw))
    for got in gots:
        assert (got[2] is None) == (not two_dots)
        for g, wt in zip(got, want):
            if wt is not None:
                assert_bitwise(g, wt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_dots_takes_q_as_the_padded_iterate(dtype):
    """stencil7_two_dots(coeffs, q) is the padded-level plain version with
    w = q passed as a tensor of its own."""
    _, ct, q, _ = _inputs((4, 5, 9), dtype, seed=7)
    q = to_t(q)
    got = tfused.stencil7_two_dots(ct, q)
    want = stencil7_dots_padded_ref(torch.nn.functional.pad(q, (1, 1) * 3), q,
                                    [ct.diags[n] for n in tst.STAR7.names], tst.STAR7.offsets,
                                    two_dots=True)
    for g, wt in zip(got, want):
        assert_bitwise(g, wt)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, ct, q, _ = _inputs((4, 4, 4), "f32")
    q = to_t(q)
    with pytest.raises(ValueError, match="match v"):
        tfused.stencil7_two_dots(ct, q.to(torch.bfloat16))
    box = tst.random_nonsymmetric(torch.Generator().manual_seed(0), (4, 4, 4), spec=tst.BOX27)
    with pytest.raises(ValueError, match="7-point"):
        tfused.stencil7_two_dots(box, q)


@pytest.mark.parametrize("shape,seed", [((8, 8, 8), 0), ((6, 5, 8), 1)])
def test_solve_ref_fused_matches_jax(shape, seed):
    """convdiff star7, f32, tol 1e-6: the same iteration count, x to rtol 1e-4."""
    cj = jst.convection_diffusion(shape)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    bj = jst.rhs_for_solution(cj, jnp.asarray(x))
    rj = jbi.solve_ref_fused(cj, bj, tol=1e-6, maxiter=200)
    rt = tbi.solve_ref_fused(carry_coeffs(cj), to_t(bj), tol=1e-6, maxiter=200)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(to_np(rt.x), to_np(rj.x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(rt.rel_residual), float(rj.rel_residual), rtol=1e-2)


def test_solve_ref_fused_is_the_fused_schedule():
    """The port's solve_ref_fused runs the same iteration as the fused
    backend: the same count to tol, and x within the dots' summation order."""
    shape = (8, 6, 8)
    cf = tst.convection_diffusion(shape, device="cpu")
    b = tst.rhs_for_solution(cf, torch.randn(shape, generator=torch.Generator().manual_seed(2)))
    rf = tbi.solve_ref_fused(cf, b, tol=1e-6)
    rs = tbi.solve_ref(cf, b, tol=1e-6, backend="fused")
    assert abs(int(rf.iterations) - int(rs.iterations)) <= 1
    assert float(torch.linalg.vector_norm(rf.x - rs.x) / torch.linalg.vector_norm(rs.x)) < 1e-5
    with pytest.raises(ValueError, match="one right-hand side"):
        tbi.solve_ref_fused(cf, b[None])
