"""The routed Mixture-of-Experts (``repro_torch/models/moe.py``) and the MoE
decoder ``qwen2_moe_a2_7b`` against ``repro.models.moe`` and
``repro.models.model``, on the JAX package's weights carried across.

* ``capacity`` equals the reference's over a grid; the token group divides
  the token count and is ``min(group_size, n_tok)`` halved as few times as
  that takes, so a decode batch of 8 at Qwen's widths is one group of 8
  with capacity 4.
* Routing: the f32 router probabilities are within ``PROB_ULPS`` f32 ulps
  of 1 of JAX's (the two sum the logits' products in other orders), the
  renormalised weights within ``W_ULPS`` ulps of JAX's, and the chosen
  experts equal JAX's, in order, for every token whose consecutive
  probabilities among its top k + 1 are more than ``MARGIN`` apart; the
  rest are counted (a near-tie may pick either expert).  Exact ties go to
  the lower expert index, as ``jax.lax.top_k``'s do.
* Both dispatches, handed JAX's routing (``w``, ``e_idx``), give JAX's
  output with the same tokens dropped: in f32 within ``F32_ULPS`` f32 ulps
  of the largest output (sum orders and FMAs differ, ROADMAP §3), in bf16
  against JAX op by op (each op rounding its output, as the port does)
  with every entry within one bf16 ulp of the largest output and at least
  ``BF16_SAME`` of them equal bit for bit (the expert matmuls' f32 sums
  run in other orders and round differently near ties).
* The whole MoE layer at decode group sizes, where the capacity clamp and
  the drops differ from prefill's, matches JAX in f32.
* The smoke model (2 layers, 8 experts, top 4, 2 shared experts, groups of
  16) served: prefill + 8 decodes, f32 logits and caches within
  ``F32_ULPS`` of JAX's with the same greedy tokens and load-balancing
  loss; bf16 logits no further from JAX's strict mode
  (``--xla_allow_excess_precision=false``, a subprocess) than JAX's default
  mode is, as ``test_torch_lm_bf16.py`` holds the dense family.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (B, EPS_F32, STEPS, T, carry, configs, jax_params, jax_serve,
                       port_serve, prompt)
from _torch_port import finish, start_with_devices, to_np, to_t
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.transformer import ParamTree

ARCH = "qwen2_moe_a2_7b"
F32_ULPS = 16
PROB_ULPS, W_ULPS = 4, 8
#: routing decisions closer than this (f32 probability) are near-ties
MARGIN = 1e-5
#: bf16 dispatch: the share of entries equal to JAX's bit for bit
BF16_SAME = 0.99
#: the bf16 smoke model: the port's gap to strict JAX against default JAX's
MODE_GAP_MULTIPLE = 1.0

#: (groups, group size, d_model, experts, top k, expert ff): the smoke
#: config's MoE, and Qwen1.5-MoE's expert count and top k at narrow widths
SHAPES = {"smoke": (4, 16, 64, 8, 4, 32), "qwen_experts": (2, 64, 128, 60, 4, 48)}


def _ulp_close(got, want, ulps: int, what: str) -> None:
    g, w = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    tol = ulps * EPS_F32 * max(np.abs(w).max(), 1.0 if "prob" in what else 0.0)
    err = np.abs(g - w).max()
    assert err <= tol, f"{what}: {err:.3e} > {ulps} ulp ({tol:.3e})"


def _inputs(shape_name: str, dtype: str, seed: int = 0):
    """(x (n, g, d), router, expert weights) as numpy, the expert weights
    and x in ``dtype``."""
    n, g, d, E, k, f = SHAPES[shape_name]
    rng = np.random.default_rng(seed)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    x = np.asarray(jnp.asarray(rng.standard_normal((n, g, d)), jdt))
    router = (rng.standard_normal((d, E)) / math.sqrt(d)).astype(np.float32)
    w = {name: np.asarray(jnp.asarray(rng.standard_normal(s) / math.sqrt(s[-2]), jdt))
         for name, s in (("w_gate", (E, d, f)), ("w_up", (E, d, f)), ("w_down", (E, f, d)))}
    return x, router, w


def _jax_route(router, xt, k):
    """The reference's routing lines (``repro/models/moe.py:moe_apply``)."""
    logits = jnp.einsum("nsd,de->nse", jnp.asarray(xt).astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    w, e_idx = jax.lax.top_k(probs, k)
    w = w / jnp.maximum(w.sum(-1, keepdims=True), 1e-9)
    return probs, w, e_idx


def _decisive(probs: np.ndarray, k: int) -> np.ndarray:
    """Tokens whose sorted probabilities 1..k+1 are all more than MARGIN apart."""
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    return (np.diff(-top, axis=-1) > MARGIN).all(-1)


def test_capacity_and_groups():
    for tokens in (1, 2, 3, 4, 5, 7, 8, 16, 17, 64, 100, 2048, 4096):
        for E in (8, 60):
            for k in (1, 2, 4):
                for factor in (1.0, 1.25, 2.0):
                    assert tmoe.capacity(tokens, E, k, factor) == jmoe.capacity(
                        tokens, E, k, factor), (tokens, E, k, factor)
    for n_tok in (1, 2, 6, 8, 12, 24, 64, 96, 2048, 16384, 24576):
        for group in (16, 2048):
            g = tmoe.tokens_per_group(n_tok, group)
            m = round(math.log2(min(group, n_tok) / g))
            assert n_tok % g == 0 and min(group, n_tok) // 2 ** m == g
            assert m == 0 or n_tok % (min(group, n_tok) // 2 ** (m - 1)), (n_tok, group)
    g = tmoe.tokens_per_group(8, 2048)
    assert (g, tmoe.capacity(g, 60, 4)) == (8, 4)
    assert tmoe.capacity(tmoe.tokens_per_group(8 * 2048, 2048), 60, 4) == 171


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_routing_matches_jax(shape, dtype):
    x, router, _ = _inputs(shape, dtype)
    k = SHAPES[shape][4]
    pj, wj, ej = _jax_route(router, x, k)
    pt, wt, et = tmoe.route(to_t(router), to_t(x), top_k=k)
    _ulp_close(pt, pj, PROB_ULPS, "probs")
    dec = _decisive(np.asarray(pj), k)
    assert dec.mean() > 0.9, dec.mean()
    assert np.array_equal(to_np(et)[dec], np.asarray(ej)[dec])
    _ulp_close(to_np(wt)[dec], np.asarray(wj)[dec], W_ULPS, "w")
    print(f"{shape}/{dtype}: {int((~dec).sum())} of {dec.size} tokens within {MARGIN} of a tie")


def test_exact_ties_go_to_the_lower_index():
    x, _, _ = _inputs("smoke", "f32")
    zeros = np.zeros((x.shape[-1], 8), np.float32)       # every logit 0: all tied
    _, _, ej = _jax_route(zeros, x, 4)
    _, _, et = tmoe.route(to_t(zeros), to_t(x), top_k=4)
    assert np.array_equal(to_np(et), np.asarray(ej))
    assert (to_np(et) == np.arange(4)).all()


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_dispatch_given_jax_routing(monkeypatch, dispatch, dtype, shape):
    """Capacity factor 1.0, so experts overflow and tokens drop."""
    n, g, d, E, k, f = SHAPES[shape]
    x, router, w = _inputs(shape, dtype, seed=1)
    cap = jmoe.capacity(g, E, k, 1.0)
    _, wj, ej = _jax_route(router, x, k)
    jp = {"router": router, **{name: jnp.asarray(a) for name, a in w.items()}}
    if dispatch == "einsum":
        want = jmoe._einsum_dispatch(jp, jnp.asarray(x), ej, wj, cap, E)
    else:
        # the scatter path is inline in moe_apply: hand it this routing
        monkeypatch.setattr(jax.lax, "top_k", lambda probs, kk: (wj, ej))
        want = jmoe.moe_apply(jp, jnp.asarray(x).reshape(n * g, 1, d), n_experts=E, top_k=k,
                              group_size=g, cap_factor=1.0, router_weights_renorm=False,
                              dispatch="scatter")[0].reshape(n, g, d)
    tp = ParamTree({name: to_t(a) for name, a in w.items()})
    got = tmoe.DISPATCHES[dispatch](tp, to_t(x), to_t(np.asarray(ej)).long(), to_t(wj), cap, E)
    # the routing drops tokens, and the dropped ones are JAX's
    counts = np.zeros((n, E), int)
    for gi in range(n):
        np.add.at(counts[gi], np.asarray(ej)[gi].reshape(-1), 1)
    assert (counts > cap).any(), "no expert overflowed: nothing was dropped"
    if dtype == "f32":
        _ulp_close(got, want, F32_ULPS, f"{dispatch} output")
        return
    g64, w64 = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    ulp = 2.0 ** -7 * 2.0 ** np.floor(np.log2(np.abs(w64).max()))
    assert np.abs(g64 - w64).max() <= ulp
    assert (g64 == w64).mean() >= BF16_SAME, (g64 == w64).mean()


@pytest.mark.parametrize("n_tok", [1, 2, 4, 8, 12])
def test_moe_layer_at_decode_group_sizes(n_tok):
    """The smoke config's MoE layer (groups of 16, shared experts) on a
    decode batch of ``n_tok`` tokens, f32: output and aux loss within
    ``F32_ULPS`` of JAX's."""
    jc, tc = configs(ARCH, "f32")
    defs = jmoe.build_params(jc.d_model, jc.n_experts, jc.d_ff_expert,
                             n_shared=jc.n_shared_experts, dtype=jnp.float32)
    rng = np.random.default_rng(n_tok)
    jp = {name: jnp.asarray((rng.standard_normal(dd.shape) / math.sqrt(dd.shape[-2])
                             ).astype(np.float32)) for name, dd in defs.items()}
    x = rng.standard_normal((n_tok, 1, jc.d_model)).astype(np.float32)
    kw = dict(n_experts=jc.n_experts, top_k=jc.top_k, group_size=jc.moe_group_size)
    want, aux_j = jmoe.moe_apply(jp, jnp.asarray(x), **kw)
    got, aux_t = tmoe.moe_apply(ParamTree({k: to_t(v) for k, v in jp.items()}), to_t(x), **kw)
    _ulp_close(got, want, F32_ULPS, "moe output")
    _ulp_close(aux_t, aux_j, F32_ULPS, "aux")


def test_decode_group_of_eight_drops():
    """Eight decode tokens at the smoke widths are one group with capacity
    5; the port's routing overflows an expert there, as JAX's does."""
    jc, _ = configs(ARCH, "f32")
    g = tmoe.tokens_per_group(8, jc.moe_group_size)
    cap = tmoe.capacity(g, jc.n_experts, jc.top_k)
    assert (g, cap) == (8, 5)
    rng = np.random.default_rng(5)
    router = (rng.standard_normal((jc.d_model, jc.n_experts)) / 8).astype(np.float32)
    x = rng.standard_normal((1, 8, jc.d_model)).astype(np.float32)
    _, _, et = tmoe.route(to_t(router), to_t(x), top_k=jc.top_k)
    _, _, ej = _jax_route(router, x, jc.top_k)
    assert np.array_equal(to_np(et), np.asarray(ej))
    assert np.bincount(to_np(et).reshape(-1).astype(int), minlength=jc.n_experts).max() > cap


def test_smoke_model_f32_matches_jax():
    jc, tc = configs(ARCH, "f32")
    jp = jax_params(jc)
    toks = prompt(jc.vocab)
    ref = jax_serve(jc, jp, toks)
    tp = carry(tc, jp)
    got = port_serve(tc, tp, toks)
    for s, (pl, rl) in enumerate(zip(got["logits"], ref["logits"])):
        assert pl.shape == (B, jc.vocab)
        _ulp_close(pl, rl, F32_ULPS, f"logits at step {s}")
    assert np.array_equal(np.stack(got["tokens"]), np.stack(ref["tokens"]))
    for pc, rc in zip(got["caches"], ref["caches"]):
        assert pc["length"] == rc["length"] == T + STEPS
        _ulp_close(pc["k"], rc["k"], F32_ULPS, "cache k")
        _ulp_close(pc["v"], rc["v"], F32_ULPS, "cache v")
    # the load-balancing loss summed over the layers, from a prefill forward
    from repro.models import model as JM  # noqa: F401  (registers the forward's deps)

    _, _, aux_j = jtr.forward(jc, jp, {"tokens": jnp.asarray(toks)}, mode="train")
    with torch.inference_mode():
        _, _, aux_t = ttr.forward(tc, tp, {"tokens": torch.from_numpy(toks).long()},
                                  mode="train", return_logits=False)
    _ulp_close(aux_t, aux_j, F32_ULPS, "aux")


_STRICT = """
import sys
import numpy as np
sys.path.insert(0, "tests")
from _torch_lm import configs, jax_params, jax_serve, prompt
jc, _ = configs(%r, "bf16")
r = jax_serve(jc, jax_params(jc), prompt(jc.vocab))
np.savez(%r, logits=np.stack(r["logits"]), tokens=np.stack(r["tokens"]))
print("ok")
"""


@pytest.fixture(scope="module", autouse=True)
def strict(tmp_path_factory):
    """Strict-mode JAX serving the bf16 smoke model, started in the
    background when the module's first test starts."""
    out = tmp_path_factory.mktemp("moe_strict") / "strict.npz"
    proc = start_with_devices(_STRICT % (ARCH, str(out)), 1, strict_bf16=True)
    yield proc, out
    proc.kill()


def test_smoke_model_bf16_within_jax_precision_mode_gap(strict):
    proc, out = strict
    finish(proc)
    ref = np.load(out)
    jc, tc = configs(ARCH, "bf16")
    jp = jax_params(jc)
    toks = prompt(jc.vocab)
    forced = ref["tokens"]
    default = jax_serve(jc, jp, toks, forced=forced)
    got = port_serve(tc, carry(tc, jp), toks, forced=forced)

    def gap(a, b):
        return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())

    port_gap = gap(np.stack(got["logits"]), ref["logits"])
    mode_gap = gap(np.stack(default["logits"]), ref["logits"])
    assert mode_gap > 0, "strict and default JAX agree: the subprocess lost its flag"
    assert port_gap <= MODE_GAP_MULTIPLE * mode_gap, (port_gap, mode_gap)
    print(json.dumps(dict(port_gap=port_gap, mode_gap=mode_gap,
                          same=float((np.stack(got["logits"]) == ref["logits"]).mean()))))
