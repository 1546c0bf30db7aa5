"""Port parity for the fused BiCGStab passes' plain versions (K2-K5) against
the JAX package's ``kernels/fused_iter/ops.py`` Pallas kernels in interpret
mode.

Tolerances:

* vectors: f32 within 2 ulp of each expression's largest term (XLA on the
  CPU contracts ``a*b+c`` into FMAs, the port never does); bf16 bitwise.
* dot partials: rtol 1e-5 in f32 (summation order).  In bf16 rtol 2e-2:
  XLA's default ``--xla_allow_excess_precision=true`` lets JAX keep f32
  values where the kernel body rounds to bf16 before the dot, which moves
  the partials by up to about 1%.  With the flag off (the subprocess test
  below) the same dots agree to 1e-6.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import assert_bitwise, assert_ulp_close, run_python, to_np, to_t  # noqa: E402
from repro.kernels.fused_iter import ops as jops  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.fused_iter import ops as tops  # noqa: E402

SHAPES = [(8, 8, 8), (5, 7, 9)]
_J = {"f32": jnp.float32, "bf16": jnp.bfloat16}
DOT_RTOL = {"f32": 1e-5, "bf16": 2e-2}
ALPHA, OMEGA, BETA = 0.37, -1.3, 0.81


def _vecs(shape, dtype, k, seed=0):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(_J[dtype])
            for _ in range(k)]


def _check_vec(got, want, dtype, scale):
    if dtype == "bf16":
        assert_bitwise(got, want)
    else:
        assert_ulp_close(got, want, scale)


def _f64(a):
    return to_np(a).astype(np.float64)


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    reset_launch_counts()
    yield
    assert not any(launch_counts().values()), launch_counts()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_update_q_dots(shape, dtype):
    r, s, y = _vecs(shape, dtype, 3)
    q, qy, yy = jops.update_q_dots(jnp.float32(ALPHA), r, s, y)
    tq, tqy, tyy = tops.update_q_dots(torch.tensor(ALPHA), to_t(r), to_t(s), to_t(y))
    _check_vec(tq, q, dtype, np.abs(_f64(r)) + np.abs(ALPHA * _f64(s)))
    np.testing.assert_allclose(float(tqy), float(qy), rtol=DOT_RTOL[dtype])
    np.testing.assert_allclose(float(tyy), float(yy), rtol=DOT_RTOL[dtype])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_update_xr_dots(shape, dtype):
    x, p, q, y, r0 = _vecs(shape, dtype, 5, seed=1)
    xo, ro, r0r, rr = jops.update_xr_dots(jnp.float32(ALPHA), jnp.float32(OMEGA),
                                          x, p, q, y, r0)
    txo, tro, tr0r, trr = tops.update_xr_dots(torch.tensor(ALPHA), torch.tensor(OMEGA),
                                              *(to_t(a) for a in (x, p, q, y, r0)))
    _check_vec(txo, xo, dtype, np.abs(_f64(x)) + np.abs(ALPHA * _f64(p))
               + np.abs(OMEGA * _f64(q)))
    _check_vec(tro, ro, dtype, np.abs(_f64(q)) + np.abs(OMEGA * _f64(y)))
    np.testing.assert_allclose(float(tr0r), float(r0r), rtol=DOT_RTOL[dtype])
    np.testing.assert_allclose(float(trr), float(rr), rtol=DOT_RTOL[dtype])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_update_p(shape, dtype):
    r, p, s = _vecs(shape, dtype, 3, seed=2)
    po = jops.update_p(jnp.float32(BETA), jnp.float32(OMEGA), r, p, s)
    tpo = tops.update_p(torch.tensor(BETA), torch.tensor(OMEGA), to_t(r), to_t(p), to_t(s))
    _check_vec(tpo, po, dtype, np.abs(_f64(r)) + np.abs(BETA) * (
        np.abs(_f64(p)) + np.abs(OMEGA * _f64(s))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dot_mixed(shape, dtype):
    a, b = _vecs(shape, dtype, 2, seed=3)
    np.testing.assert_allclose(float(tops.dot_mixed(to_t(a), to_t(b))),
                               float(jops.dot_mixed(a, b)), rtol=DOT_RTOL[dtype])


def test_q_in_equals_kernel_q_bitwise():
    """The fused loop forms the SpMV input as ``r - st(alpha)*s`` with plain
    tensor ops; it must equal update_q_dots' q bitwise (bicgstab.py:148)."""
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(4)
        r, s, y = (torch.randn((6, 5, 7), generator=g).to(dtype) for _ in range(3))
        alpha = torch.tensor(0.6180339)
        q, _, _ = tops.update_q_dots(alpha, r, s, y)
        assert_bitwise(r - alpha.to(dtype) * s, q)


def test_noncontiguous_operands_raise():
    r = torch.randn((4, 6, 8))[:, ::2]
    with pytest.raises(RuntimeError):
        tops.update_p(torch.tensor(1.0), torch.tensor(1.0), r, r, r)


_STRICT = """
import json, numpy as np, jax.numpy as jnp, torch
from repro.kernels.fused_iter import ops as jops
from repro_torch.kernels.fused_iter import ops as tops
from repro_torch.device import tensor_from_numpy, tensor_to_numpy
t_ = lambda a: tensor_from_numpy(np.asarray(a))
n_ = lambda a: (tensor_to_numpy(a) if hasattr(a, "detach")
                else np.asarray(jnp.asarray(a, jnp.float32)))
rng = np.random.default_rng(7)
v = [jnp.asarray(rng.standard_normal((8, 8, 8)).astype(np.float32)).astype(jnp.bfloat16)
     for _ in range(5)]
T = [t_(a) for a in v]
a, w, b = jnp.float32(0.37), jnp.float32(-1.3), jnp.float32(0.81)
ta, tw, tb = torch.tensor(0.37), torch.tensor(-1.3), torch.tensor(0.81)
J = {"q": jops.update_q_dots(a, v[0], v[1], v[2]),
     "xr": jops.update_xr_dots(a, w, *v),
     "p": (jops.update_p(b, w, v[0], v[1], v[2]),),
     "dot": (jops.dot_mixed(v[0], v[1]),)}
P = {"q": tops.update_q_dots(ta, T[0], T[1], T[2]),
     "xr": tops.update_xr_dots(ta, tw, *T),
     "p": (tops.update_p(tb, tw, T[0], T[1], T[2]),),
     "dot": (tops.dot_mixed(T[0], T[1]),)}
out = {}
for k in J:
    for i, (x, y) in enumerate(zip(J[k], P[k])):
        x, y = n_(x), n_(y)
        if x.ndim:
            out[f"{k}{i}_neq"] = int((x != y).sum())
        else:
            out[f"{k}{i}_rel"] = float(abs(x - y) / abs(x))
print(json.dumps(out))
"""


def test_bf16_strict_precision_bitwise_subprocess():
    """With ``--xla_allow_excess_precision=false`` JAX rounds every bf16 op
    as written, like the port: bf16 vectors bitwise, dots to 1e-6."""
    out = run_python(_STRICT, env_extra={
        "XLA_FLAGS": "--xla_allow_excess_precision=false", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    neq = {k: v for k, v in res.items() if k.endswith("_neq")}
    rel = {k: v for k, v in res.items() if k.endswith("_rel")}
    assert set(neq) == {"q0_neq", "xr0_neq", "xr1_neq", "p0_neq"}
    assert not any(neq.values()), neq
    assert len(rel) == 5 and max(rel.values()) <= 1e-6, rel
