"""RWKV-6 (``repro_torch/models/rwkv6.py``, ``layers.groupnorm_heads``) and the
``rwkv6_7b`` smoke model against ``repro.models.rwkv6`` / ``model``, on the
same inputs made with numpy from a seed (the model's weights: the JAX
package's, carried across).

Tolerances, in f32 ulps of the reference's largest magnitude:

* ``groupnorm_heads``, ``wkv_recurrent`` and ``channel_mix``: ``F32_ULPS``
  (the order of f32 sums and XLA's FMAs, ROADMAP §3; at most 1 was seen).
* ``wkv_chunked`` forms ``k exp(-P)`` and ``r exp(P - ld)`` with P a
  chunk's cumulative log-decay, so each term's rounding is scaled up by
  up to exp(|P|) before the terms cancel: the reference's own chunked form
  is up to 23 ulps from the exact (float64) recurrence on these inputs.
  The port sums P in XLA's order (``cumsum_xla``, bit for bit), so its
  chunked form is within ``F32_ULPS`` of JAX's (1.7 seen; up to 31 with
  ``torch.cumsum``), and no further than ``CHUNK_FACTOR`` x JAX's distance
  (+ ``F32_ULPS``) from the exact recurrence and from its own recurrence.
* ``time_mix``: ``BLOCK_ULPS`` (6.5 seen: the projections' and decay's
  sums in other orders, through the per-head norm); in its chunked form
  no more than ``CHUNK_FACTOR`` x JAX's own chunked-to-recurrent gap.
* The served model (prefill through the chunked form, decodes through the
  recurrence, two layers): ``SERVE_ULPS``.  50 was seen on the logits and
  59 on the caches; JAX op by op (``jax.disable_jit``) is 32 ulps from
  jitted JAX on the same weights.  The chunked form sums up to 64
  log-decays and exponentiates the sum, so one ulp in each decay (its
  einsum sums in another order) can move ``exp(-P)`` by up to 64 ulps.
* bfloat16: the port's logits no further from JAX's strict mode
  (``--xla_allow_excess_precision=false``) than JAX's default mode is;
  98.2% of them equal strict JAX's bit for bit (0.016 against the modes'
  0.109).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (B, bf16_mode_gaps, carry, check_f32_serving, configs,
                       jax_params, prompt, strict_fixture, ulps)
from _torch_port import to_np, to_t
from repro.models import layers as jl
from repro.models import rwkv6 as jr
from repro_torch.models import layers as tl
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as tr
from repro_torch.models.transformer import ParamTree

ARCH = "rwkv6_7b"
F32_ULPS = 4
BLOCK_ULPS = 16
CHUNK_FACTOR = 2.0
SERVE_ULPS = 128


def _wkv_inputs(T: int, seed: int = 0, B_: int = 2, H: int = 4, D: int = 16):
    """r, k, v, log-decay (about -1 a step, as the smoke model's), bonus and a
    carried state, as numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B_, T, H, D)).astype(np.float32) for _ in range(3))
    ld = -np.exp(0.3 * rng.standard_normal((B_, T, H, D))).astype(np.float32)
    bonus = rng.standard_normal((H, D)).astype(np.float32)
    state = rng.standard_normal((B_, H, D, D)).astype(np.float32)
    return r, k, v, ld, bonus, state


def _jax(fn, *a, **kw):
    return fn(*(jnp.asarray(x) for x in a), **kw)


def _port(fn, *a, **kw):
    return fn(*(to_t(x) for x in a), **kw)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_groupnorm_heads(dt):
    rng = np.random.default_rng(3)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    x = jnp.asarray(3 + rng.standard_normal((2, 5, 4, 16)).astype(np.float32)).astype(jdt)
    w, b = (jnp.asarray(rng.standard_normal((4, 16)).astype(np.float32)) for _ in range(2))
    want = jl.groupnorm_heads(w, b, x)
    got = tl.groupnorm_heads(to_t(w), to_t(b), to_t(x))
    assert got.dtype == (torch.float32 if dt == "f32" else torch.bfloat16)
    if dt == "f32":
        assert ulps(to_np(got), to_np(want)) <= F32_ULPS
    else:
        g, w_ = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
        assert np.abs(g - w_).max() <= 2.0 ** -7 * np.abs(w_).max()
    # eps is RWKV's 64e-5: a constant head normalises to b, not to (x - mu) / sqrt(1e-5)
    const = torch.ones((1, 1, 4, 16))
    assert torch.equal(tl.groupnorm_heads(to_t(w), to_t(b), const), to_t(b).expand(1, 1, 4, 16))


@pytest.mark.parametrize("T", [1, 37, 64])
def test_wkv_recurrent_matches_jax(T):
    args = _wkv_inputs(T)
    jo, jS = _jax(jr.wkv_recurrent, *args)
    to, tS = _port(tr.wkv_recurrent, *args)
    assert ulps(to_np(to), np.asarray(jo)) <= F32_ULPS
    assert ulps(to_np(tS), np.asarray(jS)) <= F32_ULPS


def _wkv_exact(r, k, v, ld, bonus, state):
    """The recurrence in float64 (numpy): the yardstick of both chunked forms."""
    r, k, v, ld, bonus, S = (np.asarray(a, np.float64) for a in (r, k, v, ld, bonus, state))
    out = []
    for t in range(r.shape[1]):
        kv = np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        out.append(np.einsum("bhk,bhkv->bhv", r[:, t], S + bonus[None, :, :, None] * kv))
        S = np.exp(ld[:, t])[..., None] * S + kv
    return np.stack(out, axis=1), S


@pytest.mark.parametrize("C", [1, 4, 16, 40, 64])
def test_cumsum_in_xlas_order(C):
    """``jnp.cumsum`` as XLA compiles it on the CPU, bit for bit: the chunked
    form's log-decay sums (blocks of 16; 40 ends in a ragged block)."""
    x = -np.exp(0.3 * np.random.default_rng(C).standard_normal((2, 3, C, 4, 5))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=2))(jnp.asarray(x)))
    assert np.array_equal(to_np(tr.cumsum_xla(to_t(x), 2)), want)


@pytest.mark.parametrize("T,chunk,C", [(64, 64, 64), (128, 64, 64), (96, 64, 32), (40, 64, 40),
                                       (80, 64, 16), (36, 16, 4)])
def test_wkv_chunked_matches_jax_and_the_recurrence(T, chunk, C):
    """T a multiple of the chunk and not (the chunk halves until it divides
    T, as the reference's does), with a carried state: within ``F32_ULPS``
    of JAX's chunked form, and as close to the exact (float64) recurrence
    as it, within ``CHUNK_FACTOR``; the port's own recurrence within that of
    its chunked form."""
    assert tr.chunk_len(T, chunk) == C
    args = _wkv_inputs(T, seed=T)
    jo, jS = _jax(jr.wkv_chunked, *args, chunk=chunk)
    to, tS = _port(tr.wkv_chunked, *args, chunk=chunk)
    to_r, tS_r = _port(tr.wkv_recurrent, *args)
    for got, want, rec, exact, what in ((to, jo, to_r, _wkv_exact(*args)[0], "o"),
                                        (tS, jS, tS_r, _wkv_exact(*args)[1], "state")):
        jax_err = ulps(np.asarray(want), exact)
        assert ulps(to_np(got), np.asarray(want)) <= F32_ULPS, what
        assert ulps(to_np(got), exact) <= CHUNK_FACTOR * jax_err + F32_ULPS, (what, jax_err)
        assert ulps(to_np(got), to_np(rec)) <= CHUNK_FACTOR * jax_err + F32_ULPS, (what, jax_err)
        assert ulps(to_np(rec), exact) <= F32_ULPS, what


def _rwkv_params(seed: int, d: int = 64, hs: int = 16, ff: int = 128, dt=jnp.float32):
    """Random weights of one RWKV block (mu and the decay base drawn too,
    not their zero init; the decay about -1 a step, so that a 16-step chunk's
    exp(-P) stays far from f32's overflow), for both packages."""
    rng = np.random.default_rng(seed)
    defs = jr.build_params(d, hs, ff, dtype=dt)
    jp = {}
    for name, dd in defs.items():
        scale = {"mu": 0.5, "cm_mu": 0.5, "bonus": 0.5, "decay_base": 0.1,
                 "decay_B": 0.3 / np.sqrt(dd.shape[0])}.get(name, 1 / np.sqrt(dd.shape[0]))
        base = 1.0 if name == "ln_x_w" else 0.0
        jp[name] = jnp.asarray((base + scale * rng.standard_normal(dd.shape)).astype(np.float32),
                               dd.dtype)
    return jp, ParamTree({k: to_t(v) for k, v in jp.items()})


@pytest.mark.parametrize("chunked", [False, True])
def test_time_mix_with_state_and_shift(chunked):
    jp, tp = _rwkv_params(0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    state = (0.1 * rng.standard_normal((2, 4, 16, 16))).astype(np.float32)
    shift = rng.standard_normal((2, 1, 64)).astype(np.float32)
    jo, (jS, jlast) = jr.time_mix(jp, jnp.asarray(x), head_size=16, state=jnp.asarray(state),
                                  shift_prev=jnp.asarray(shift), chunked=chunked, chunk=16)
    with torch.inference_mode():
        to, (tS, tlast) = tr.time_mix(tp, to_t(x), head_size=16, state=to_t(state),
                                      shift_prev=to_t(shift), chunked=chunked, chunk=16)
    assert torch.equal(tlast, to_t(x)[:, -1:])
    if not chunked:
        assert ulps(to_np(to), np.asarray(jo)) <= BLOCK_ULPS
        assert ulps(to_np(tS), np.asarray(jS)) <= BLOCK_ULPS
        return
    # the chunked form's own noise: JAX's chunked block against its recurrent one
    jo_r, (jS_r, _) = jr.time_mix(jp, jnp.asarray(x), head_size=16, state=jnp.asarray(state),
                                  shift_prev=jnp.asarray(shift), chunked=False)
    for got, want, own in ((to, jo, jo_r), (tS, jS, jS_r)):
        lim = max(BLOCK_ULPS, CHUNK_FACTOR * ulps(np.asarray(want), np.asarray(own)))
        assert ulps(to_np(got), np.asarray(want)) <= lim


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_channel_mix_with_shift(dt):
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    jp, tp = _rwkv_params(2, dt=jdt)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 9, 64)).astype(np.float32), jdt)
    shift = jnp.asarray(rng.standard_normal((2, 1, 64)).astype(np.float32), jdt)
    jo, jlast = jr.channel_mix(jp, x, shift_prev=shift)
    to, tlast = tr.channel_mix(tp, to_t(x), shift_prev=to_t(shift))
    assert np.array_equal(to_np(tlast), to_np(jlast))
    if dt == "f32":
        assert ulps(to_np(to), np.asarray(jo)) <= F32_ULPS
    else:       # op by op JAX rounds where the port does: one bf16 ulp at most
        g, w = to_np(to).astype(np.float64), to_np(jo).astype(np.float64)
        assert np.abs(g - w).max() <= 2.0 ** -7 * np.abs(w).max()


def test_f32_serving_matches_reference():
    check_f32_serving(ARCH, SERVE_ULPS)


def test_chunked_prefill_equals_prefill_then_recurrent_decodes():
    """prefill(T) and 64 decode steps fed the next 64 tokens (the recurrence)
    against prefill(T + 64) (the chunked form over two chunks): the last
    logits and every layer's WKV state and shifts."""
    jc, tc = configs(ARCH, "f32")
    tp = carry(tc, jax_params(jc))
    T, n = 64, 64
    toks = torch.from_numpy(prompt(jc.vocab, t=T + n)).long()
    pre, serve = TM.make_prefill_step(tc, TM.SHAPES["smoke_prefill"]), TM.make_serve_step(tc)
    caches = TM.init_caches(tc, B, T + n, device="cpu")
    logits, caches = pre(tp, {"tokens": toks[:, :T]}, caches)
    for s in range(n):
        logits, caches = serve(tp, {"token": toks[:, T + s:T + s + 1]}, caches)
    whole = TM.init_caches(tc, B, T + n, device="cpu")
    want, whole = pre(tp, {"tokens": toks}, whole)
    assert ulps(to_np(logits[:, -1]), to_np(want[:, -1])) <= SERVE_ULPS
    for a, b in zip(caches, whole):
        for name in ("wkv", "tm_shift", "cm_shift"):
            assert ulps(to_np(a[name]), to_np(b[name])) <= SERVE_ULPS, name


def test_caches_follow_the_defs_and_default_to_the_card():
    cfg = configs(ARCH, "bf16")[1]
    caches = TM.init_caches(cfg, 3, 16, "cpu")
    H = cfg.d_model // cfg.rwkv_head_size
    assert len(caches) == cfg.n_layers
    for c in caches:
        assert set(c) == {"wkv", "tm_shift", "cm_shift"}
        assert c["wkv"].shape == (3, H, cfg.rwkv_head_size, cfg.rwkv_head_size)
        assert c["wkv"].dtype == torch.float32
        assert c["tm_shift"].shape == c["cm_shift"].shape == (3, 1, cfg.d_model)
        assert c["tm_shift"].dtype == torch.bfloat16
        assert c["tm_shift"].data_ptr() != c["cm_shift"].data_ptr()
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert TM.init_caches(cfg, 1, 4)[0]["wkv"].is_cuda
        assert TM.init_params(cfg, gen).embed.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_caches(cfg, 1, 4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_params(cfg, gen)


strict = strict_fixture(ARCH)


def test_bf16_serving_within_jax_precision_mode_gap(strict):
    bf16_mode_gaps(ARCH, strict)
