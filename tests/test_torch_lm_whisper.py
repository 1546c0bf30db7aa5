"""Whisper's encoder-decoder (``repro_torch/models/attention.py``'s
``cross_attention`` and ``encode_cross_kv``, the ``enc_dec`` forward of
``models/transformer.py``) and the ``whisper_large_v3`` smoke model against
``repro.models.attention`` / ``model``, on the same inputs made with numpy
from a seed (the model's weights: the JAX package's, carried across).

The encoder's frames are random, from the seed (the conv frontend is a stub
in both packages), ``ENC_FRAMES`` = 12 of them: not the config's
``enc_len_decode`` of 8, since prefill replaces the cross K/V with the
frames' own length, as the reference does.  Tolerances: ``F32_ULPS`` f32
ulps of the reference's largest magnitude (6.7 seen on the served logits,
3.8 on the caches; the encoder's bidirectional attention and the padded
last key block of ``flash_attention`` are the reference's arithmetic, kept),
one bf16 ulp for the cross-attention layer in bf16 against JAX op by op,
and the served bf16 logits no further from JAX's strict mode than JAX's
default mode is (99.99% equal to strict JAX bit for bit seen).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (B, ENC_FRAMES, bf16_mode_gaps, carry, check_f32_serving, configs,
                       extras, jax_params, prompt, strict_fixture, ulps)
from _torch_port import to_np, to_t
from repro.models import attention as ja
from repro_torch.models import attention as ta
from repro_torch.models import model as TM
from repro_torch.models.transformer import ENC_SPEC, ParamTree

ARCH = "whisper_large_v3"
F32_ULPS = 16
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cross_params(dt: str, d=64, H=4, K=2, Dh=16, seed=0):
    rng = np.random.default_rng(seed)
    jp = {name: jnp.asarray((rng.standard_normal(dd.shape) / np.sqrt(dd.shape[0])
                             ).astype(np.float32), DTYPES[dt][0])
          for name, dd in ja.build_params(d, H, K, Dh, cross=True).items()}
    return jp, ParamTree({k: to_t(v) for k, v in jp.items()})


def _close(got, want, dt: str, n: float = F32_ULPS):
    if dt == "f32":
        assert ulps(to_np(got), to_np(want)) <= n
    else:
        g, w = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
        assert np.abs(g - w).max() <= 2.0 ** -7 * np.abs(w).max()


def test_cross_params_are_the_references():
    got = ta.build_params(64, 4, 2, 16, cross=True)
    want = ja.build_params(64, 4, 2, 16, cross=True)
    assert set(got) == set(want) == {"wq", "wk", "wv", "wo", "c_wq", "c_wk", "c_wv", "c_wo"}
    for k in got:
        assert (got[k].shape, got[k].axes, got[k].init) == (want[k].shape, want[k].axes,
                                                            want[k].init)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,block", [(12, 1024), (12, 8), (5, 4)])
def test_encode_cross_kv_and_cross_attention(dt, S, block):
    """No mask and no RoPE; ``block`` < S pads the last key block as the
    reference's flash attention does."""
    jp, tp = _cross_params(dt)
    rng = np.random.default_rng(S + block)
    enc = jnp.asarray(rng.standard_normal((2, S, 64)).astype(np.float32), DTYPES[dt][0])
    x = jnp.asarray(rng.standard_normal((2, 7, 64)).astype(np.float32), DTYPES[dt][0])
    jk, jv = ja.encode_cross_kv(jp, enc)
    tk, tv = ta.encode_cross_kv(tp, to_t(enc))
    _close(tk, jk, dt)
    _close(tv, jv, dt)
    want = ja.cross_attention(jp, x, (jk, jv), n_kv=2, block=block)
    got = ta.cross_attention(tp, to_t(x), (to_t(jk), to_t(jv)), n_kv=2, block=block)
    assert got.shape == (2, 7, 64) and got.dtype == DTYPES[dt][1]
    _close(got, want, dt)


def test_f32_serving_matches_reference():
    check_f32_serving(ARCH, F32_ULPS)


def test_encoder_blocks_and_the_cross_cache():
    """The model holds ``n_enc_layers`` bidirectional encoder blocks; the
    cross K/V start at ``enc_len_decode`` frames, prefill replaces them with
    the frames' length (new tensors, not copies into the old buffers), and
    the decodes read them unchanged."""
    jc, tc = configs(ARCH, "f32")
    tp = carry(tc, jax_params(jc))
    assert len(tp.enc_layers) == tc.n_enc_layers and all(b.spec == ENC_SPEC for b in tp.enc_layers)
    assert not ENC_SPEC.causal and hasattr(tp, "enc_norm")
    caches = TM.init_caches(tc, B, 40, device="cpu")
    assert caches[0]["cross_k"].shape == (B, tc.enc_len_decode, tc.n_kv_heads, tc.d_head)
    old = caches[0]["cross_k"]
    batch = {"tokens": torch.from_numpy(prompt(jc.vocab)).long(),
             "frames": to_t(extras(jc)["frames"])}
    logits, caches = TM.make_prefill_step(tc, TM.SHAPES["smoke_prefill"])(tp, batch, caches)
    ck = caches[0]["cross_k"]
    assert ck.shape == (B, ENC_FRAMES, tc.n_kv_heads, tc.d_head) and ck is not old
    snap = ck.clone()
    serve = TM.make_serve_step(tc)
    logits, caches = serve(tp, {"token": logits[:, -1].argmax(-1)[:, None]}, caches)
    assert torch.equal(caches[0]["cross_k"], snap)


strict = strict_fixture(ARCH)


def test_bf16_serving_within_jax_precision_mode_gap(strict):
    bf16_mode_gaps(ARCH, strict)
