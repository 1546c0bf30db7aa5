"""PaliGemma's VLM prefix (``frontend="vlm"`` in ``models/transformer.py``)
and the ``paligemma_3b`` smoke model against ``repro.models.model``, on the
same inputs made with numpy from a seed (the model's weights: the JAX
package's, carried across).

The patch embeddings are random, from the seed (the vision tower is a stub
in both packages).  They are prepended after the token embedding's sqrt(d)
scale, take positions 0..P-1, and the prefix is attended bidirectionally
(prefix-LM), so the cache holds P + T positions after prefill.
Tolerances: ``F32_ULPS`` f32 ulps of the reference's largest magnitude (2.0
seen on the logits, 3.4 on the caches); bf16 logits no further from JAX's
strict mode than JAX's default mode is (all equal to strict JAX's bit for
bit seen).
"""

import numpy as np
import torch

from _torch_lm import (B, T, bf16_mode_gaps, carry, check_f32_serving, configs, extras,
                       jax_params, prompt, strict_fixture)
from _torch_port import to_t
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttr

ARCH = "paligemma_3b"
F32_ULPS = 16


def test_f32_serving_matches_reference():
    check_f32_serving(ARCH, F32_ULPS)


def _hidden(tc, tp, toks, patches):
    with torch.inference_mode():
        return ttr.forward(tc, tp, {"tokens": toks, "patch_embeds": patches}, mode="train",
                           return_logits=False)[0]


def test_prefix_is_bidirectional_and_unscaled():
    """A change to the last patch reaches the first position (bidirectional
    prefix); a change to the last token reaches no prefix position (causal
    after it); the patches enter unscaled, the tokens scaled by sqrt(d); and
    the cache holds P + T positions after prefill."""
    jc, tc = configs(ARCH, "f32")
    tp = carry(tc, jax_params(jc))
    toks = torch.from_numpy(prompt(jc.vocab)).long()
    patches = to_t(extras(jc)["patch_embeds"])
    P = patches.shape[1]
    base = _hidden(tc, tp, toks, patches)
    moved = patches.clone()
    moved[:, -1] += 1.0
    assert not torch.equal(_hidden(tc, tp, toks, moved)[:, 0], base[:, 0])
    late = toks.clone()
    late[:, -1] = (late[:, -1] + 1) % jc.vocab
    h = _hidden(tc, tp, late, patches)
    assert torch.equal(h[:, :P + T - 1], base[:, :P + T - 1])
    assert not torch.equal(h[:, -1], base[:, -1])

    seen = {}
    real = ttr.stack_apply

    def spy(cfg, layers, x, **kw):
        seen.setdefault("x", x.clone())
        seen.setdefault("prefix_len", kw["prefix_len"])
        return real(cfg, layers, x, **kw)

    ttr.stack_apply = spy
    try:
        caches = TM.init_caches(tc, B, P + T + 1, device="cpu")
        _, caches = TM.make_prefill_step(tc, TM.SHAPES["smoke_prefill"])(
            tp, {"tokens": toks, "patch_embeds": patches}, caches)
    finally:
        ttr.stack_apply = real
    assert seen["prefix_len"] == P and caches[0]["attn"].length == P + T
    assert torch.equal(seen["x"][:, :P], patches)
    scale = torch.sqrt(torch.tensor(float(tc.d_model)))
    assert torch.equal(seen["x"][:, P:], tp.embed[toks] * scale)


strict = strict_fixture(ARCH)


def test_bf16_serving_within_jax_precision_mode_gap(strict):
    g = bf16_mode_gaps(ARCH, strict)
    assert g["same"] > 0.99, g
