"""The many-RHS batch axis of the port: the batched kernels' plain versions
(K1b, K2b-K5b) and the batched solve, against the JAX package, plus the
port's own invariants (mirroring ``tests/test_batched.py``).

The JAX batched Pallas path runs in interpret mode here, so the kernel
comparisons use blocks of at most 8x8x8 and B = 2.  Tolerances:

* vectors: f32 within 2 ulp of each expression's largest term (XLA on the
  CPU contracts ``a*b+c`` into FMAs, the port never does); bf16 bitwise,
  in-process where the arithmetic leaves XLA nothing to keep in f32 (the
  stencil: a bf16 product is exact in f32), else under
  ``--xla_allow_excess_precision=false`` in a subprocess;
* dots: within 1e-5 of sum|a_i b_i| in f32 (summation order; a share of the
  sum of magnitudes, since a cross dot of random vectors may nearly
  cancel), 2e-2 of it in bf16 in-process (XLA's excess precision, see
  ``test_torch_kernel_fused_iter.py``), rtol 1e-6 strict;
* solves: the same per-RHS iteration counts, x to rtol 1e-4.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import (  # noqa: E402
    assert_bitwise, assert_ulp_close, carry_coeffs, run_python, to_np, to_t,
)
from repro.core import bicgstab as jbi  # noqa: E402
from repro.core import stencil as jst  # noqa: E402
from repro.kernels.fused_iter import ops as jops  # noqa: E402
from repro.kernels.stencil_nd.kernel import stencil_nd_pallas  # noqa: E402
from repro_torch.core import bicgstab as tbi  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import stencil as tst  # noqa: E402
from repro_torch.core.comm import HaloExchange  # noqa: E402
from repro_torch.core.halo import FabricAxes, gather_halo  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.fused_iter import kernel as tk  # noqa: E402
from repro_torch.kernels.fused_iter import ops as tops  # noqa: E402
from repro_torch.kernels.stencil_nd import stencil_apply  # noqa: E402
from repro_torch.kernels.stencil_nd.kernel import stencil_nd, stencil_nd_batched  # noqa: E402

B = 2
SHAPE = (8, 8, 6)
BACKENDS = ["reference", "spmd", "fused"]
_JBACKEND = {"reference": "reference", "spmd": "spmd", "fused": "pallas"}
_J = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_T = {"f32": torch.float32, "bf16": torch.bfloat16}
DOT_RTOL = {"f32": 1e-5, "bf16": 2e-2}
ALPHA, OMEGA, BETA = [0.37, 0.81], [-1.3, -0.4], [0.81, 0.2]


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    reset_launch_counts()
    yield
    assert not any(launch_counts().values()), launch_counts()


# ---------------------------------------------------------------------------
# K1b: the batched stencil's plain version against stencil_nd_pallas batched
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("specname", ["star7", "box27", "star25"])
@pytest.mark.parametrize("storage,accum", [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32")])
def test_batched_stencil_matches_pallas(specname, storage, accum):
    spec = jst.get_spec(specname)
    r, shape = spec.radius, (6, 5, 8)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal((B,) + shape).astype(np.float32)).astype(_J[storage])
    cfs = [jnp.asarray((rng.standard_normal(shape) * 0.2).astype(np.float32)).astype(_J[storage])
           for _ in spec.offsets]
    vp = jnp.pad(v, ((0, 0),) + ((r, r),) * 3)
    uj = stencil_nd_pallas(vp, cfs, spec.offsets, radius=r, zc=shape[2], accum_dtype=_J[accum])
    tcf = [to_t(c) for c in cfs]
    ut = stencil_nd_batched(to_t(vp), tcf, spec.offsets, radius=r, accum_dtype=_T[accum])
    assert ut.dtype == _T[storage] and tuple(ut.shape) == (B,) + shape
    for i in range(B):       # each slice is the unbatched plain version, bit for bit
        assert_bitwise(ut[i], stencil_nd(to_t(vp[i]), tcf, spec.offsets, radius=r,
                                         accum_dtype=_T[accum]))
    if storage == "bf16":
        assert_bitwise(ut, uj)
        return
    vpn = to_np(vp).astype(np.float64)
    win = lambda off: vpn[(slice(None),) + tuple(slice(r + o, r + o + n)
                                                 for o, n in zip(off, shape))]
    scale = np.abs(win((0, 0, 0))) + sum(np.abs(to_np(c) * win(off))
                                         for c, off in zip(cfs, spec.offsets))
    assert_ulp_close(ut, uj, scale)


@pytest.mark.parametrize("specname", ["star7", "box27"])
def test_batched_stencil_apply_is_apply_ref(specname):
    """ops.stencil_apply pads only the mesh axes of a batch: apply_ref bitwise."""
    spec = tst.get_spec(specname)
    cf = tst.random_nonsymmetric(torch.Generator().manual_seed(2), (5, 6, 7), spec=spec)
    v = torch.randn((3, 5, 6, 7), generator=torch.Generator().manual_seed(3))
    assert_bitwise(stencil_apply(cf, v), tst.apply_ref(cf, v))


def test_one_rank_halo_of_a_batch():
    """gather_halo and HaloExchange on a (B, X, Y, Z) block: the zero pad of
    the mesh axes only, and the exchange's shape is the mesh block's."""
    v = torch.randn((B, 4, 5, 6), generator=torch.Generator().manual_seed(0))
    vp = gather_halo(v, FabricAxes(), 2, n_batch=1)
    assert tuple(vp.shape) == (B, 8, 9, 10)
    assert_bitwise(vp[:, 2:-2, 2:-2, 2:-2], v)
    ring = vp.clone()
    ring[:, 2:-2, 2:-2, 2:-2] = 0
    assert not bool(ring.any())
    ex = HaloExchange(v, FabricAxes(), 2, n_batch=1)
    assert ex.shape == (4, 5, 6)
    assert_bitwise(ex.padded, vp)


# ---------------------------------------------------------------------------
# K2b-K5b: the batched fused passes' plain versions against ops.*(batched=True)
# ---------------------------------------------------------------------------

def _bvecs(shape, dtype, k, seed):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal((B,) + shape).astype(np.float32)).astype(_J[dtype])
            for _ in range(k)]


def _check_vec(got, want, dtype, scale):
    if dtype == "bf16":
        assert_bitwise(got, want)
    else:
        assert_ulp_close(got, want, scale)


def _f64(a):
    return to_np(a).astype(np.float64)


def _dots_close(got, want, a, b, dtype):
    """[B] dots within DOT_RTOL of each RHS's sum |a_i b_i|."""
    scale = np.abs(_f64(a) * _f64(b)).reshape(B, -1).sum(axis=1)
    assert np.all(np.abs(_f64(got) - _f64(want)) <= DOT_RTOL[dtype] * scale), (got, want)


def _bc(s, shape):
    return np.asarray(s, np.float64).reshape((B,) + (1,) * len(shape))


SHAPES = [(8, 8, 8), (5, 7, 9)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batched_update_q_dots(shape, dtype):
    r, s, y = _bvecs(shape, dtype, 3, 0)
    a = jnp.asarray(ALPHA, jnp.float32)
    q, qy, yy = jops.update_q_dots(a, r, s, y, batched=True)
    tr, ts, ty = map(to_t, (r, s, y))
    tq, tqy, tyy = tops.update_q_dots(torch.tensor(ALPHA), tr, ts, ty, batched=True)
    _check_vec(tq, q, dtype, np.abs(_f64(r)) + np.abs(_bc(ALPHA, shape) * _f64(s)))
    _dots_close(tqy, qy, tq, ty, dtype)
    _dots_close(tyy, yy, ty, ty, dtype)
    for i in range(B):       # each RHS is the unbatched plain version, bit for bit
        for got, want in zip((tq[i], tqy[i], tyy[i]),
                             tops.update_q_dots(torch.tensor(ALPHA[i]), tr[i], ts[i], ty[i])):
            assert_bitwise(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batched_update_xr_dots(shape, dtype):
    x, p, q, y, r0 = _bvecs(shape, dtype, 5, 1)
    a, w = jnp.asarray(ALPHA, jnp.float32), jnp.asarray(OMEGA, jnp.float32)
    xo, ro, r0r, rr = jops.update_xr_dots(a, w, x, p, q, y, r0, batched=True)
    tv = [to_t(t) for t in (x, p, q, y, r0)]
    got = tops.update_xr_dots(torch.tensor(ALPHA), torch.tensor(OMEGA), *tv, batched=True)
    _check_vec(got[0], xo, dtype, np.abs(_f64(x)) + np.abs(_bc(ALPHA, shape) * _f64(p))
               + np.abs(_bc(OMEGA, shape) * _f64(q)))
    _check_vec(got[1], ro, dtype, np.abs(_f64(q)) + np.abs(_bc(OMEGA, shape) * _f64(y)))
    _dots_close(got[2], r0r, tv[4], got[1], dtype)
    _dots_close(got[3], rr, got[1], got[1], dtype)
    for i in range(B):
        solo = tops.update_xr_dots(torch.tensor(ALPHA[i]), torch.tensor(OMEGA[i]),
                                   *(t[i] for t in tv))
        for g, want in zip((t[i] for t in got), solo):
            assert_bitwise(g, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batched_update_p(shape, dtype):
    r, p, s = _bvecs(shape, dtype, 3, 2)
    b_, w = jnp.asarray(BETA, jnp.float32), jnp.asarray(OMEGA, jnp.float32)
    po = jops.update_p(b_, w, r, p, s, batched=True)
    tv = [to_t(t) for t in (r, p, s)]
    tpo = tops.update_p(torch.tensor(BETA), torch.tensor(OMEGA), *tv, batched=True)
    _check_vec(tpo, po, dtype, np.abs(_f64(r)) + np.abs(_bc(BETA, shape)) * (
        np.abs(_f64(p)) + np.abs(_bc(OMEGA, shape) * _f64(s))))
    for i in range(B):
        assert_bitwise(tpo[i], tops.update_p(torch.tensor(BETA[i]), torch.tensor(OMEGA[i]),
                                             *(t[i] for t in tv)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batched_dot_mixed(shape, dtype):
    a, b = _bvecs(shape, dtype, 2, 3)
    ta, tb = to_t(a), to_t(b)
    got = tops.dot_mixed(ta, tb, batched=True)
    assert tuple(got.shape) == (B,) and got.dtype == torch.float32
    _dots_close(got, jops.dot_mixed(a, b, batched=True), ta, tb, dtype)
    for i in range(B):
        assert_bitwise(got[i], tops.dot_mixed(ta[i], tb[i]))


def test_batched_wrapper_takes_b_by_n_operands():
    """The kernel wrappers take ``(B, n)`` batches; ops views ``(B, ...)``."""
    r = torch.randn((B, 4, 6, 8))
    q, qy, yy = tops.update_q_dots(torch.tensor(ALPHA), r, r, r, batched=True)
    assert tuple(q.shape) == tuple(r.shape) and tuple(qy.shape) == (B,)
    q2, _, _ = tk.update_q_dots_batched(torch.tensor(ALPHA), *(r.view(B, -1),) * 3)
    assert_bitwise(q2.view(r.shape), q)


_STRICT = """
import json, numpy as np, jax.numpy as jnp, torch
from repro.kernels.fused_iter import ops as jops
from repro.kernels.stencil_nd.kernel import stencil_nd_pallas
from repro.core import stencil as jst
from repro_torch.kernels.fused_iter import ops as tops
from repro_torch.kernels.stencil_nd.kernel import stencil_nd_batched
from repro_torch.device import tensor_from_numpy, tensor_to_numpy
t_ = lambda a: tensor_from_numpy(np.asarray(a))
n_ = lambda a: (tensor_to_numpy(a) if hasattr(a, "detach")
                else np.asarray(jnp.asarray(a, jnp.float32)))
rng = np.random.default_rng(7)
v = [jnp.asarray(rng.standard_normal((2, 8, 8, 8)).astype(np.float32)).astype(jnp.bfloat16)
     for _ in range(5)]
T = [t_(a) for a in v]
a, w, b = (jnp.asarray(x, jnp.float32) for x in ([0.37, 0.81], [-1.3, -0.4], [0.81, 0.2]))
ta, tw, tb = (torch.tensor(x) for x in ([0.37, 0.81], [-1.3, -0.4], [0.81, 0.2]))
J = {"q": jops.update_q_dots(a, v[0], v[1], v[2], batched=True),
     "xr": jops.update_xr_dots(a, w, *v, batched=True),
     "p": (jops.update_p(b, w, v[0], v[1], v[2], batched=True),),
     "dot": (jops.dot_mixed(v[0], v[1], batched=True),)}
P = {"q": tops.update_q_dots(ta, T[0], T[1], T[2], batched=True),
     "xr": tops.update_xr_dots(ta, tw, *T, batched=True),
     "p": (tops.update_p(tb, tw, T[0], T[1], T[2], batched=True),),
     "dot": (tops.dot_mixed(T[0], T[1], batched=True),)}
spec = jst.STAR7
vp = jnp.pad(v[0], ((0, 0),) + ((1, 1),) * 3)
cfs = [(0.2 * x[0]).astype(jnp.bfloat16) for x in v[1:]] + [(0.1 * v[1][1]).astype(jnp.bfloat16),
                                                           (0.3 * v[2][1]).astype(jnp.bfloat16)]
J["k1b"] = (stencil_nd_pallas(vp, cfs, spec.offsets, radius=1, zc=8,
                              accum_dtype=jnp.bfloat16),)
P["k1b"] = (stencil_nd_batched(t_(vp), [t_(c) for c in cfs], spec.offsets, radius=1,
                               accum_dtype=torch.bfloat16),)
out = {}
for k in J:
    for i, (x, y) in enumerate(zip(J[k], P[k])):
        x, y = n_(x), n_(y)
        if x.ndim > 1:
            out[f"{k}{i}_neq"] = int((x != y).sum())
        else:
            out[f"{k}{i}_rel"] = float(np.max(np.abs(x - y) / np.abs(x)))
print(json.dumps(out))
"""


def test_bf16_strict_precision_bitwise_subprocess():
    """With ``--xla_allow_excess_precision=false`` JAX rounds every bf16 op
    as written, like the port: the batched bf16 vectors of K1b-K4b bitwise,
    the [B] dots to 1e-6."""
    out = run_python(_STRICT, env_extra={
        "XLA_FLAGS": "--xla_allow_excess_precision=false", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    neq = {k: v for k, v in res.items() if k.endswith("_neq")}
    rel = {k: v for k, v in res.items() if k.endswith("_rel")}
    assert set(neq) == {"q0_neq", "xr0_neq", "xr1_neq", "p0_neq", "k1b0_neq"}
    assert not any(neq.values()), neq
    assert len(rel) == 5 and max(rel.values()) <= 1e-6, rel


# ---------------------------------------------------------------------------
# The batched solve against JAX solve_ref with batched b
# ---------------------------------------------------------------------------

def _jax_system(nb=B, seed=1, shape=(8, 8, 8)):
    # convdiff, as test_torch_solve.py: the symmetric Poisson system's f32
    # residual tail near 1e-6 is spiky, and the summation order alone then
    # moves a count
    cj = jst.convection_diffusion(shape)
    x = np.random.default_rng(seed).standard_normal((nb,) + shape).astype(np.float32)
    bj = jst.rhs_for_solution(cj, jnp.asarray(x))
    return cj, carry_coeffs(cj), bj, to_t(bj)


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_solve_matches_jax(backend):
    cj, ct, bj, bt = _jax_system()
    rj = jbi.solve_ref(cj, bj, tol=1e-6, maxiter=200, backend=_JBACKEND[backend])
    rt = tbi.solve_ref(ct, bt, tol=1e-6, maxiter=200, backend=backend)
    assert rt.iterations.shape == (B,) and rt.x.shape == bt.shape
    assert bool(rt.converged.all()) and bool(np.asarray(rj.converged).all())
    assert rt.iterations.tolist() == np.asarray(rj.iterations).tolist()
    np.testing.assert_allclose(to_np(rt.x), to_np(rj.x), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The port's own invariants (tests/test_batched.py)
# ---------------------------------------------------------------------------

def _port_system(nb=None, seed=1, shape=SHAPE):
    cf = tst.poisson(shape, device="cpu")
    xshape = shape if nb is None else (nb,) + shape
    x = torch.randn(xshape, generator=torch.Generator().manual_seed(seed))
    return cf, tst.rhs_for_solution(cf, x)


@pytest.mark.parametrize("schedule", ["blocking", "overlap"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_b1_batched_bitwise_identical_to_unbatched(backend, schedule):
    """The acceptance bar: a (1, ...) solve IS the unbatched solve."""
    cf, b = _port_system()
    kw = dict(tol=1e-5, maxiter=60, policy=tprec.F32, backend=backend, schedule=schedule)
    ru = tbi.solve_ref(cf, b, **kw)
    rb = tbi.solve_ref(cf, b[None], **kw)
    assert tuple(rb.x.shape) == (1,) + SHAPE
    assert_bitwise(rb.x[0], ru.x)
    assert int(rb.iterations[0]) == int(ru.iterations)
    assert bool(rb.converged[0]) == bool(ru.converged)
    assert_bitwise(rb.rel_residual[0], ru.rel_residual)


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_matches_per_rhs_solo_bitwise(backend):
    """Each RHS of a B=3 block solve is its solo solve: iterations, x and
    residual, bit for bit (a converged RHS freezes while the others run)."""
    cf, b = _port_system(nb=3)
    kw = dict(tol=1e-5, maxiter=80, policy=tprec.F32, backend=backend)
    rb = tbi.solve_ref(cf, b, **kw)
    assert rb.iterations.shape == (3,)
    for i in range(3):
        ri = tbi.solve_ref(cf, b[i], **kw)
        assert int(rb.iterations[i]) == int(ri.iterations)
        assert_bitwise(rb.x[i], ri.x)
        assert_bitwise(rb.rel_residual[i], ri.rel_residual)


@pytest.mark.parametrize("backend", BACKENDS)
def test_converged_rhs_freezes_while_others_iterate(backend):
    """A zero RHS converges at iteration 0 (x stays zero, its counter stays
    0) while the live RHS runs its whole solo trajectory beside it."""
    cf, b1 = _port_system()
    b = torch.stack([torch.zeros_like(b1), b1])
    kw = dict(tol=1e-5, maxiter=80, policy=tprec.F32, backend=backend)
    rb = tbi.solve_ref(cf, b, **kw)
    assert int(rb.iterations[0]) == 0 and bool(rb.converged[0])
    assert not bool(rb.x[0].any())
    ri = tbi.solve_ref(cf, b1, **kw)
    assert int(rb.iterations[1]) == int(ri.iterations) > 0
    assert_bitwise(rb.x[1], ri.x)


def test_batched_history_shape_and_freeze():
    cf, b = _port_system(nb=2, seed=4)
    b = torch.stack([b[0], 1e3 * b[1]])   # different problems, different exits
    maxiter = 30
    rb = tbi.solve_ref(cf, b, tol=1e-5, maxiter=maxiter, policy=tprec.F32,
                       record_history=True)
    h = rb.history
    assert tuple(h.shape) == (maxiter, 2)
    for i in range(2):      # after an RHS exits its history repeats its exit residual
        k = int(rb.iterations[i])
        assert k < maxiter and bool((h[k - 1:, i] == rb.rel_residual[i]).all())


def test_batched_breakdown_mask_is_per_rhs():
    """Breakdown and convergence are [B] masks; a healthy pair breaks none."""
    cf, b1 = _port_system()
    b = torch.stack([b1, 2.0 * b1])
    rb = tbi.solve_ref(cf, b, tol=1e-12, maxiter=5, policy=tprec.F32)
    assert rb.breakdown.shape == (2,) and rb.converged.shape == (2,)
    assert not bool(rb.breakdown.any())
    assert rb.iterations.tolist() == [5, 5]


def test_batched_rhs_shape_is_checked():
    cf, b = _port_system(nb=2)
    with pytest.raises(ValueError, match="shape"):
        tbi.solve_ref(cf, b[None])
    with pytest.raises(ValueError, match="shape"):
        tbi.solve_ref(cf, b[..., :-1])
