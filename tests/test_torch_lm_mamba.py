"""Mamba (``repro_torch/models/mamba.py``) and the Jamba smoke model
(``jamba_v0_1_52b``: Mamba layers 7:1 with attention, a routed MoE on the odd
positions) against ``repro.models.mamba`` / ``model``, on the same inputs
made with numpy from a seed (the model's weights: the JAX package's, carried
across).

Tolerances, in f32 ulps of the reference's largest magnitude:

* ``_associative_scan`` equals ``jax.lax.associative_scan`` run op by op
  bit for bit (the same recursion, so the same products and sums), and the
  jitted one within ``F32_ULPS`` (XLA contracts ``a2 * b1 + b2`` into an
  FMA on the CPU, ROADMAP §3).
* ``mamba_apply`` / ``mamba_decode`` against the jitted reference:
  ``BLOCK_ULPS`` (11.6 seen: the block ends in an RMSNorm over d_inner
  channels, whose rounding the discretisation's ``exp`` feeds; JAX op by op
  is 4.7 from jitted JAX).
* The served model (eight layers, prefill + 8 decodes): ``SERVE_ULPS``.
  128 was seen on the logits and 79 on the caches (the conv state, the
  last pre-activation inputs of layers whose inputs have passed 7 layers);
  JAX op by op (``jax.disable_jit``) is 60 ulps from jitted JAX on the same
  weights.
* bfloat16: the port's logits no further from JAX's strict mode
  (``--xla_allow_excess_precision=false``) than JAX's default mode is
  (0.31 against 0.37 seen); 84.6% of them equal strict JAX's bit for bit,
  fewer than the dense family's 91-99.99%: eight layers of bf16 conv sums,
  gates and RMSNorms, and a top-2 router, where one flipped rounding moves
  later layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (B, bf16_mode_gaps, carry, check_f32_serving, configs, jax_params,
                       prompt, strict_fixture, ulps)
from _torch_port import to_np, to_t
from repro.models import mamba as jm
from repro_torch.models import mamba as tm
from repro_torch.models import model as TM
from repro_torch.models.transformer import ParamTree

ARCH = "jamba_v0_1_52b"
F32_ULPS = 4
BLOCK_ULPS = 32
SERVE_ULPS = 256


def _combine(a, b):
    """The reference's combine (``repro/models/mamba.py:mamba_apply``)."""
    return a[0] * b[0], b[0] * a[1] + b[1]


def test_softplus_is_jaxs_logaddexp():
    x = np.concatenate([np.linspace(-40, 40, 4001), [-1e4, 1e4, 0.0]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = to_np(tm.softplus(to_t(x)))
    # two f32 ulps of each value (log1p/exp of two libraries; 2 seen), everywhere
    assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)))
    assert got[-2] == 1e4 and got[0] > 0


@pytest.mark.parametrize("T", [1, 2, 5, 32, 37, 64])
def test_associative_scan_in_jaxs_order(T):
    rng = np.random.default_rng(T)
    a = np.exp(-0.3 * np.abs(rng.standard_normal((2, T, 8, 4)))).astype(np.float32)
    b = rng.standard_normal((2, T, 8, 4)).astype(np.float32)
    ja, jb = jax.lax.associative_scan(_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = tm._associative_scan(to_t(a), to_t(b))
    assert np.array_equal(to_np(ta), np.asarray(ja)) and np.array_equal(to_np(tb), np.asarray(jb))
    ka, kb = jax.jit(lambda a_, b_: jax.lax.associative_scan(_combine, (a_, b_), axis=1))(
        jnp.asarray(a), jnp.asarray(b))
    assert ulps(to_np(tb), np.asarray(kb)) <= F32_ULPS
    none, tb2 = tm._associative_scan(to_t(a), to_t(b), with_a=False)
    assert (none is None or T < 2) and torch.equal(tb2, tb)
    # the recurrence it computes
    h, want = np.zeros((2, 8, 4)), []
    for t in range(T):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want.append(h)
    assert ulps(to_np(tb), np.stack(want, 1)) <= F32_ULPS


def _mamba_params(seed: int, d: int = 64, n: int = 4, dt=jnp.float32):
    """Random weights of one Mamba block (the ones-initialised leaves drawn
    around 1), for both packages."""
    rng = np.random.default_rng(seed)
    jp = {}
    for name, dd in jm.build_params(d, d_state=n, d_conv=4, expand=2, dtype=dt).items():
        base = 1.0 if dd.init == "ones" else 0.0
        scale = 0.3 if dd.init in ("ones", "zeros") else 1 / np.sqrt(dd.shape[0])
        jp[name] = jnp.asarray((base + scale * rng.standard_normal(dd.shape)).astype(np.float32),
                               dd.dtype)
    return jp, ParamTree({k: to_t(v) for k, v in jp.items()})


@pytest.mark.parametrize("T", [32, 37])
@pytest.mark.parametrize("carried", [False, True])
def test_mamba_apply_matches_jax(T, carried):
    jp, tp = _mamba_params(0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, T, 64)).astype(np.float32)
    kw = {}
    if carried:
        kw = dict(state=(0.5 * rng.standard_normal((2, 128, 4))).astype(np.float32),
                  conv_state=rng.standard_normal((2, 3, 128)).astype(np.float32))
    jo, (jS, jc) = jax.jit(jm.mamba_apply)(jp, jnp.asarray(x), **{k: jnp.asarray(v)
                                                                  for k, v in kw.items()})
    with torch.inference_mode():
        to, (tS, tc) = tm.mamba_apply(tp, to_t(x), **{k: to_t(v) for k, v in kw.items()})
    assert ulps(to_np(to), np.asarray(jo)) <= BLOCK_ULPS
    assert ulps(to_np(tS), np.asarray(jS)) <= BLOCK_ULPS
    # the new conv state: the last d_conv - 1 inputs before the activation
    assert ulps(to_np(tc), np.asarray(jc)) <= F32_ULPS
    xs, _ = tm._ssm_inputs(tp, to_t(x))
    assert torch.equal(tc, xs[:, -3:])


def test_mamba_decode_matches_jax():
    jp, tp = _mamba_params(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    S = (0.5 * rng.standard_normal((2, 128, 4))).astype(np.float32)
    c = rng.standard_normal((2, 3, 128)).astype(np.float32)
    jo, (jS, jc) = jax.jit(jm.mamba_decode)(jp, jnp.asarray(x), jnp.asarray(S), jnp.asarray(c))
    to, (tS, tc) = tm.mamba_decode(tp, to_t(x), to_t(S), to_t(c))
    assert to.shape == (2, 1, 64)
    assert ulps(to_np(to), np.asarray(jo)) <= BLOCK_ULPS
    assert ulps(to_np(tS), np.asarray(jS)) <= BLOCK_ULPS
    assert np.array_equal(to_np(tc), np.asarray(jc))


def test_block_prefill_then_decode_equals_longer_prefill():
    """mamba_apply over T, then mamba_decode of token T + 1 from its states,
    against mamba_apply over T + 1: the last output and both states."""
    _, tp = _mamba_params(4)
    x = to_t(np.random.default_rng(5).standard_normal((2, 33, 64)).astype(np.float32))
    _, (S, c) = tm.mamba_apply(tp, x[:, :32])
    o1, (S1, c1) = tm.mamba_decode(tp, x[:, 32:], S, c)
    o2, (S2, c2) = tm.mamba_apply(tp, x)
    assert ulps(to_np(o1), to_np(o2[:, -1:])) <= BLOCK_ULPS
    assert ulps(to_np(S1), to_np(S2)) <= BLOCK_ULPS
    assert ulps(to_np(c1), to_np(c2)) <= F32_ULPS    # products over 32 and 1 rows


def test_f32_serving_matches_reference():
    check_f32_serving(ARCH, SERVE_ULPS)


def test_served_prefill_then_decode_equals_longer_prefill():
    """The smoke model: prefill(T) and one decode step against prefill(T + 1)
    (the Mamba prefill starts from zero state, whatever the cache holds, as
    the reference's does): the last logits and every layer's SSM and conv
    states and attention K/V.  One request of T = 30 tokens: the MoE groups
    are then 2 tokens (prefill of 30) and 1 (prefill of 31, a decode), so no
    expert's capacity drops a token in either run; a drop depends on the
    group a token shares, and would differ between the two by the
    reference's own semantics.  All 31 keys fit one attention block (a
    ragged block's zero padding counts in the reference's softmax, so
    prefills over other key counts would dilute attention differently)."""
    from repro_torch.models.moe import capacity, tokens_per_group

    jc, tc = configs(ARCH, "f32")
    tp = carry(tc, jax_params(jc))
    T = 30
    assert tc.attn_block > T + 1
    for n_tok in (T, T + 1, 1):
        g = tokens_per_group(n_tok, tc.moe_group_size)
        assert g <= 2 and capacity(g, tc.n_experts, tc.top_k) >= g
    toks = torch.from_numpy(prompt(jc.vocab, b=1, t=T + 1)).long()
    pre, serve = TM.make_prefill_step(tc, TM.SHAPES["smoke_prefill"]), TM.make_serve_step(tc)
    caches = pre(tp, {"tokens": toks[:, :T]}, TM.init_caches(tc, 1, T + 1, device="cpu"))[1]
    logits, caches = serve(tp, {"token": toks[:, T:]}, caches)
    want, whole = pre(tp, {"tokens": toks}, TM.init_caches(tc, 1, T + 1, device="cpu"))
    assert ulps(to_np(logits[:, -1]), to_np(want[:, -1])) <= SERVE_ULPS
    for spec, a, b in zip(tc.layer_specs(), caches, whole):
        if spec.kind == "mamba":
            assert ulps(to_np(a["ssm"]), to_np(b["ssm"])) <= SERVE_ULPS
            assert ulps(to_np(a["conv"]), to_np(b["conv"])) <= SERVE_ULPS
        else:
            assert a["attn"].length == b["attn"].length == T + 1
            assert ulps(to_np(a["attn"].k), to_np(b["attn"].k)) <= SERVE_ULPS


def test_caches_follow_the_defs_and_default_to_the_card():
    cfg = configs(ARCH, "bf16")[1]
    caches = TM.init_caches(cfg, 3, 16, "cpu")
    d_in = cfg.mamba_expand * cfg.d_model
    assert [set(c) for c in caches] == [
        {"attn"} if s.kind == "attn" else {"ssm", "conv"} for s in cfg.layer_specs()]
    for spec, c in zip(cfg.layer_specs(), caches):
        if spec.kind == "mamba":
            assert c["ssm"].shape == (3, d_in, cfg.mamba_d_state) and c["ssm"].dtype == torch.float32
            assert c["conv"].shape == (3, cfg.mamba_d_conv - 1, d_in)
            assert c["conv"].dtype == torch.bfloat16
    if torch.cuda.is_available():
        assert TM.init_caches(cfg, 1, 4)[0]["ssm"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_caches(cfg, 1, 4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_params(cfg, torch.Generator().manual_seed(0))


strict = strict_fixture(ARCH)


def test_bf16_serving_within_jax_precision_mode_gap(strict):
    bf16_mode_gaps(ARCH, strict)
