"""The LM layers of the port (``repro_torch.models.layers``, the dense MLP of
``repro_torch.models.moe``) against ``repro.models.layers`` / ``moe`` on the
same inputs, made with numpy from a seed.

JAX runs op by op here (no ``jit``), so each of its bfloat16 operations
rounds as written, as the port's do.  What is left between the two is the
order of f32 sums (matrix products, means, softmax sums) and one-ulp
differences of transcendental functions, and XLA's FMA contraction on the
CPU.  So float32 results agree to a few f32 ulps of each output's largest
magnitude (``F32_ULPS``; 2.3 at most was seen), and bfloat16 results to one
bfloat16 ulp of it (``BF16_ULPS``: an f32 difference that flips one rounding
moves one bf16 output by one ulp; every case here was seen equal bit for
bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_np, to_t
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import ParamTree

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
EPS = {"f32": 2.0 ** -23, "bf16": 2.0 ** -7}
F32_ULPS = 4
BF16_ULPS = 1


def _close(port, ref, dt: str) -> None:
    p, r = to_np(port).astype(np.float64), to_np(ref).astype(np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    n = F32_ULPS if dt == "f32" else BF16_ULPS
    tol = n * EPS[dt] * np.abs(r).max()
    err = np.abs(p - r).max()
    assert err <= tol, f"max |port - jax| {err:.3e} > {n} ulp of max|jax| ({tol:.3e})"


def _arr(rng, shape, dt: str, scale: float = 1.0):
    """The same values for both packages: a JAX array and its torch copy."""
    a = jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32)).astype(
        DTYPES[dt][0])
    return a, to_t(a)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(dt, theta):
    rng = np.random.default_rng(0)
    xj, xt = _arr(rng, (2, 24, 3, 16), dt)
    pos = rng.integers(0, 4096, (2, 24)).astype(np.int32)
    _close(tl.rope(xt, torch.from_numpy(pos), theta), jl.rope(xj, jnp.asarray(pos), theta), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(dt, norm):
    rng = np.random.default_rng(1)
    xj, xt = _arr(rng, (2, 7, 96), dt, scale=3.0)
    wj, wt = _arr(rng, (96,), "f32")
    if norm == "rmsnorm":
        got, want = tl.rmsnorm(wt, xt), jl.rmsnorm(wj, xj)
    else:
        bj, bt = _arr(rng, (96,), "f32")
        got, want = tl.layernorm(wt, bt, xt), jl.layernorm(wj, bj, xj)
    assert got.dtype == DTYPES[dt][1]
    _close(got, want, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_dense_apply(dt, act):
    rng = np.random.default_rng(2)
    d, f = 32, 80
    xj, xt = _arr(rng, (2, 5, d), dt)
    if act == "gelu":
        names = {"up": (d, f), "up_b": (f,), "down": (f, d), "down_b": (d,)}
    else:
        names = {"gate": (d, f), "up": (d, f), "down": (f, d)}
    pj, pt = {}, {}
    for k, shape in names.items():
        pj[k], pt[k] = _arr(rng, shape, dt, scale=1 / np.sqrt(shape[0]))
    got = tmoe.dense_apply(ParamTree(pt), xt, act=act)
    want = jmoe.dense_apply(pj, xj, act=act)
    _close(got, want, dt)


#: (name, T, block, causal, window, prefix_len, softcap)
FLASH_CASES = [
    ("causal_one_block", 16, 16, True, None, 0, None),
    ("causal_blocks", 16, 4, True, None, 0, None),        # the online softmax steps 4 times
    ("causal_ragged", 14, 4, True, None, 0, None),        # last block padded by 2
    ("window", 16, 4, True, 5, 0, None),
    ("window_ragged", 13, 4, True, 3, 0, None),
    ("prefix_lm", 16, 4, True, None, 6, None),            # q_eff = max(pos, prefix - 1)
    ("bidirectional_ragged", 14, 4, False, None, 0, None),
    ("softcap", 16, 4, True, None, 0, 5.0),
]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention(dt, case):
    _, T, block, causal, window, prefix_len, softcap = case
    rng = np.random.default_rng(3)
    B, K, G, D = 2, 2, 3, 8
    qj, qt = _arr(rng, (B, T, K, G, D), dt, scale=2.0)
    kj, kt = _arr(rng, (B, T, K, D), dt, scale=2.0)
    vj, vt = _arr(rng, (B, T, K, D), dt)
    pos = np.arange(T, dtype=np.int32)
    q_eff = np.maximum(pos, prefix_len - 1) if prefix_len else pos
    kw = dict(causal=causal, window=window, block=block, softcap=softcap)
    got = tl.flash_attention(qt, kt, vt, torch.from_numpy(q_eff), torch.from_numpy(pos), **kw)
    want = jl.flash_attention(qj, kj, vj, jnp.asarray(q_eff), jnp.asarray(pos), **kw)
    _close(got, want, dt)


def test_ragged_block_counts_padded_keys_as_the_reference_does():
    """Padded keys sit at position -10**9: with no window they pass the causal
    test, so a ragged last block changes the result against one unpadded
    block, in the reference and identically in the port."""
    rng = np.random.default_rng(4)
    qj, qt = _arr(rng, (1, 6, 1, 1, 4), "f32")
    kj, kt = _arr(rng, (1, 6, 1, 4), "f32")
    vj, vt = _arr(rng, (1, 6, 1, 4), "f32")
    pos = torch.arange(6)
    whole = tl.flash_attention(qt, kt, vt, pos, pos, block=6)
    ragged = tl.flash_attention(qt, kt, vt, pos, pos, block=4)
    assert np.abs(to_np(whole) - to_np(ragged)).max() > 1e-3
    _close(ragged, jl.flash_attention(qj, kj, vj, jnp.arange(6), jnp.arange(6), block=4), "f32")


#: (name, cache_len, window): cache_len past S is the clamped decode
DECODE_CASES = [
    ("partial", 7, None),
    ("window", 9, 4),
    ("full", 12, None),
    ("clamped", 13, None),
    ("clamped_window", 15, 4),
]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_attention(dt, case):
    _, cache_len, window = case
    rng = np.random.default_rng(5)
    B, S, K, G, D = 2, 12, 2, 3, 8
    qj, qt = _arr(rng, (B, 1, K, G, D), dt, scale=2.0)
    kj, kt = _arr(rng, (B, S, K, D), dt, scale=2.0)
    vj, vt = _arr(rng, (B, S, K, D), dt)
    got = tl.decode_attention(qt, kt, vt, cache_len, 0, window=window)
    want = jl.decode_attention(qj, kj, vj, jnp.int32(cache_len), 0, window=window)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_activations(dt):
    rng = np.random.default_rng(6)
    gj, gt = _arr(rng, (3, 40), dt, scale=3.0)
    uj, ut = _arr(rng, (3, 40), dt)
    _close(tl.swiglu(gt, ut), jl.swiglu(gj, uj), dt)
    _close(tl.gelu(gt), jl.gelu(gj), dt)
