"""The port's serving path (``repro_torch.models.model``: prefill, KV cache,
greedy decode) against ``repro.models.model`` in float32, on the JAX
package's own weights carried across.

Both sides run the four dense smoke configs in float32 (``dtype`` replaced
on both), so every difference is the order of f32 sums, one-ulp
differences of transcendental functions and XLA's FMA contraction on the
CPU (ROADMAP §3).  Over two layers and eight decode steps those stay within
``F32_ULPS`` f32 ulps of each output's largest magnitude (at most 6.3 were
seen, on logits and caches alike), and greedy tokens are equal.  The bfloat16 comparison
is ``test_torch_lm_bf16.py``.
"""

import numpy as np
import pytest
import torch

from _torch_lm import (ARCHS, B, EPS_F32, STEPS, T, carry, configs, jax_params, jax_serve,
                       port_serve, prompt)

F32_ULPS = 16

#: (arch, attn_block): gemma3 also with 8-key blocks, so its prefill's online
#: softmax steps 4 times, under its 8-wide window
CASES = [(a, None) for a in ARCHS] + [("gemma3_12b", 8)]


def _close(port, ref, what: str) -> None:
    p, r = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    tol = F32_ULPS * EPS_F32 * np.abs(r).max()
    err = np.abs(p - r).max()
    assert err <= tol, f"{what}: max |port - jax| {err:.3e} > {F32_ULPS} ulp ({tol:.3e})"


def _same_caches(port: list, ref: list, what: str) -> None:
    assert len(port) == len(ref)
    for n, (pc, rc) in enumerate(zip(port, ref)):
        assert pc["length"] == rc["length"], (what, n, pc["length"], rc["length"])
        _close(pc["k"], rc["k"], f"{what} layer {n} k")
        _close(pc["v"], rc["v"], f"{what} layer {n} v")


@pytest.mark.parametrize("arch,block", CASES, ids=[f"{a}-block{b}" if b else a for a, b in CASES])
def test_f32_serving_matches_reference(arch, block):
    jc, tc = configs(arch, "f32", block=block)
    jp = jax_params(jc)
    toks = prompt(jc.vocab)
    ref = jax_serve(jc, jp, toks)
    got = port_serve(tc, carry(tc, jp), toks)
    for s, (pl, rl) in enumerate(zip(got["logits"], ref["logits"])):
        assert pl.shape == (B, jc.vocab)
        _close(pl, rl, f"logits at step {s}")
    assert np.array_equal(np.stack(got["tokens"]), np.stack(ref["tokens"]))
    _same_caches(got["prefill_caches"], ref["prefill_caches"], "after prefill")
    _same_caches(got["caches"], ref["caches"], f"after {STEPS} decodes")
    assert got["caches"][0]["length"] == T + STEPS


def test_decode_past_the_end_of_the_cache_clamps_as_the_reference_does():
    """A cache of exactly T slots: every decode writes its key into the last
    slot (a clamp, not a wrap), attends over all S slots, keeps length S and
    ropes at the true position, as the reference does."""
    jc, tc = configs("qwen2_1_5b", "f32")
    jp = jax_params(jc)
    toks = prompt(jc.vocab)
    ref = jax_serve(jc, jp, toks, steps=4, max_len=T)
    got = port_serve(tc, carry(tc, jp), toks, steps=4, max_len=T)
    for s, (pl, rl) in enumerate(zip(got["logits"], ref["logits"])):
        _close(pl, rl, f"logits at step {s}")
    assert np.array_equal(np.stack(got["tokens"]), np.stack(ref["tokens"]))
    _same_caches(got["caches"], ref["caches"], "after 4 clamped decodes")
    assert all(c["length"] == T for c in got["caches"])
    # the first T-1 slots are the prefill's; only the last one was overwritten
    for pre, post in zip(got["prefill_caches"], got["caches"]):
        assert np.array_equal(pre["k"][:, :T - 1], post["k"][:, :T - 1])
        assert not np.array_equal(pre["k"][:, T - 1], post["k"][:, T - 1])


def test_layer_order_follows_the_reference_period_stacking():
    """gemma3's smoke config at two periods (12 layers: 5 windowed + 1 global,
    twice), every layer's norm weights distinct: the carried model matches the
    reference, and the same weights unstacked along the wrong axis (layer
    i * n_periods + p for position i of period p) do not."""
    import jax

    jc, tc = configs("gemma3_12b", "f32", n_layers=12)
    rng = np.random.default_rng(7)
    jp = jax_params(jc)
    for pos in jp["layers"].values():
        for ln in ("ln1", "ln2"):
            w = pos[ln]["w"]
            pos[ln]["w"] = jax.numpy.asarray(
                1.0 + 0.5 * rng.standard_normal(w.shape).astype(np.float32))
    toks = prompt(jc.vocab)
    ref = jax_serve(jc, jp, toks, steps=2)
    right = carry(tc, jp)
    got = port_serve(tc, right, toks, steps=2)
    for pl, rl in zip(got["logits"], ref["logits"]):
        _close(pl, rl, "logits")

    wrong = carry(tc, jp)
    P, n = len(tc.period), tc.n_periods
    for p in range(n):
        for i in range(P):
            wrong.layers[i * n + p].load_state_dict(right.layers[p * P + i].state_dict())
    bad = port_serve(tc, wrong, toks, steps=2)
    err = max(np.abs(b - r).max() for b, r in zip(bad["logits"], ref["logits"]))
    assert err > 1e3 * F32_ULPS * EPS_F32 * np.abs(ref["logits"][0]).max(), err


def test_steps_run_under_inference_mode_and_update_caches_in_place():
    jc, tc = configs("deepseek_7b", "f32")
    from repro_torch.models import model as TM

    tp = carry(tc, jax_params(jc))
    caches = TM.init_caches(tc, B, T + 1, device="cpu")
    k0 = caches[0]["attn"].k
    logits, caches = TM.make_prefill_step(tc, TM.SHAPES["smoke_prefill"])(
        tp, {"tokens": torch.from_numpy(prompt(jc.vocab)).long()}, caches)
    assert logits.shape == (B, 1, jc.vocab) and logits.is_inference()
    assert caches[0]["attn"].k is k0 and caches[0]["attn"].length == T
    assert isinstance(caches[0]["attn"].length, int)
