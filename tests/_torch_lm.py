"""Helpers for the LM serving parity tests (``tests/test_torch_lm_*.py``).

Both packages serve the same weights (the JAX package's ``init_params``,
carried across with ``params_from_numpy``) and the same prompts (numpy, from
a seed): a prefill of B x T tokens (with the encoder's frames or the VLM's patch
embeddings where the architecture takes them, :func:`extras`), then decode
steps fed either each side's own greedy token or a given token sequence.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

# one intra-op thread per test process (see tests/_torch_port.py)
torch.set_num_threads(1)

B, T, STEPS = 2, 32, 8
ARCHS = ["qwen2_1_5b", "deepseek_7b", "stablelm_12b", "gemma3_12b"]
#: the routed-MoE decoder (its serving tests: test_torch_lm_moe.py)
MOE_ARCHS = ["qwen2_moe_a2_7b"]
#: the recurrent, hybrid, encoder-decoder, VLM and softcapped-MoE families
#: (test_torch_lm_{rwkv6,mamba,whisper,paligemma,grok}.py)
FAMILY_ARCHS = ["rwkv6_7b", "jamba_v0_1_52b", "whisper_large_v3", "paligemma_3b",
                "grok_1_314b"]
#: the encoder's frames in the tests: not enc_len_decode (8 in the smoke
#: config), since prefill replaces the cross K/V with the frames' own length
ENC_FRAMES = 12
EPS_F32 = 2.0 ** -23


def configs(arch: str, dtype: str = "bf16", block: int | None = None, n_layers: int | None = None):
    """The JAX package's smoke config and the port's, in ``dtype``."""
    import jax.numpy as jnp
    import torch

    from repro.configs import get_smoke as jget
    from repro_torch.configs import get_smoke as tget

    jc, tc = jget(arch), tget(arch)
    change = {}
    if block is not None:
        change["attn_block"] = block
    if n_layers is not None:
        change["n_layers"] = n_layers
    jc, tc = dataclasses.replace(jc, **change), dataclasses.replace(tc, **change)
    if dtype == "f32":
        jc = dataclasses.replace(jc, dtype=jnp.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return jc, tc


def jax_params(jc, seed: int = 0):
    import jax

    from repro.models import model as JM

    return JM.init_params(jc, jax.random.PRNGKey(seed))


def carry(tc, jp):
    import jax

    from repro_torch.models.param import params_from_numpy

    return params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")


def prompt(vocab: int, b: int = B, t: int = T, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def extras(jc, b: int = B, seed: int = 2) -> dict:
    """The non-token inputs of ``jc``'s prefill as numpy in its dtype: the
    VLM's ``patch_embeds`` (b, n_frontend_tokens, d) or the encoder's
    ``frames`` (b, ENC_FRAMES, d); empty for a decoder-only model."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    out = {}
    if jc.frontend == "vlm":
        out["patch_embeds"] = (jc.n_frontend_tokens, jc.d_model)
    if jc.enc_dec:
        out["frames"] = (ENC_FRAMES, jc.d_model)
    return {k: np.asarray(jnp.asarray(rng.standard_normal((b,) + s).astype(np.float32),
                                      jc.dtype)) for k, s in out.items()}


def prefix_len(extra: dict) -> int:
    return extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def ref_layer_caches(jc, tree) -> list[dict]:
    """The reference's stacked cache tree as one dict per layer, in layer
    order (period position ``i`` of period ``p`` is layer
    ``p * len(period) + i``): ``k``, ``v``, ``length`` for an attention
    cache, and every other leaf (``cross_k``, ``ssm``, ``wkv``...) by name,
    widened to f32."""
    out = []
    for p in range(jc.n_periods):
        for i in range(len(jc.period)):
            c = dict(tree[f"pos{i}"])
            a = c.pop("attn", None)
            d = {name: _f32(leaf[p]) for name, leaf in c.items()}
            if a is not None:
                d.update(k=_f32(a.k[p]), v=_f32(a.v[p]), length=int(np.asarray(a.length)[p]))
            out.append(d)
    return out


def port_layer_caches(caches) -> list[dict]:
    from repro_torch.device import tensor_to_numpy

    # copies: the port writes its cache buffers in place at every step
    out = []
    for c in caches:
        c = dict(c)
        a = c.pop("attn", None)
        d = {name: tensor_to_numpy(t).copy() for name, t in c.items()}
        if a is not None:
            d.update(k=tensor_to_numpy(a.k).copy(), v=tensor_to_numpy(a.v).copy(),
                     length=a.length)
        out.append(d)
    return out


def jax_serve(jc, jp, toks: np.ndarray, steps: int = STEPS, max_len: int | None = None,
              forced: np.ndarray | None = None, extra: dict | None = None) -> dict:
    """Prefill + ``steps`` decodes through ``jax.jit`` of the reference's steps
    (``extra``: the prefill's other inputs, :func:`extras`).  Returns the
    last-position logits of every step (f32 numpy), the tokens fed to the
    decodes, and the caches after prefill and after the last step."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM

    b, t = toks.shape
    extra = extra or {}
    caches = JM.init_caches(jc, b, max_len or t + steps + prefix_len(extra))
    prefill = jax.jit(JM.make_prefill_step(jc, JM.SHAPES["smoke_prefill"]))
    serve = jax.jit(JM.make_serve_step(jc))
    batch = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extra.items()}}
    logits, caches = prefill(jp, batch, caches)
    out = dict(logits=[np.asarray(logits[:, -1], np.float32)], tokens=[],
               prefill_caches=ref_layer_caches(jc, caches))
    for s in range(steps):
        tok = (forced[s] if forced is not None
               else np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32))
        out["tokens"].append(tok)
        logits, caches = serve(jp, {"token": jnp.asarray(tok[:, None], jnp.int32)}, caches)
        out["logits"].append(np.asarray(logits[:, -1], np.float32))
    out["caches"] = ref_layer_caches(jc, caches)
    return out


def port_serve(tc, tp, toks: np.ndarray, steps: int = STEPS, max_len: int | None = None,
               forced: np.ndarray | None = None, extra: dict | None = None) -> dict:
    """``jax_serve`` through the port's steps on the CPU."""
    import torch

    from repro_torch.device import tensor_from_numpy, tensor_to_numpy
    from repro_torch.models import model as TM

    b, t = toks.shape
    extra = extra or {}
    caches = TM.init_caches(tc, b, max_len or t + steps + prefix_len(extra), device="cpu")
    prefill = TM.make_prefill_step(tc, TM.SHAPES["smoke_prefill"])
    serve = TM.make_serve_step(tc)
    batch = {"tokens": torch.from_numpy(toks).long(),
             **{k: tensor_from_numpy(v, "cpu") for k, v in extra.items()}}
    logits, caches = prefill(tp, batch, caches)
    out = dict(logits=[tensor_to_numpy(logits[:, -1])], tokens=[],
               prefill_caches=port_layer_caches(caches))
    for s in range(steps):
        tok = (forced[s] if forced is not None
               else logits[:, -1].argmax(-1).numpy().astype(np.int32))
        out["tokens"].append(tok)
        logits, caches = serve(tp, {"token": torch.from_numpy(tok[:, None]).long()}, caches)
        out["logits"].append(tensor_to_numpy(logits[:, -1]))
    out["caches"] = port_layer_caches(caches)
    return out


def ulps(got, want) -> float:
    """max |got - want| in f32 ulps of max |want|."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / (EPS_F32 * max(np.abs(w).max(), 1e-30)))


def check_f32_serving(arch: str, tol_ulps: float) -> dict:
    """The smoke config of ``arch`` in f32, served by both packages (prefill
    + STEPS decodes on its own greedy tokens): every step's logits and every
    cache leaf, after prefill and after the last decode, within ``tol_ulps``
    f32 ulps of the reference's largest magnitude, the same greedy tokens and
    cache lengths.  Returns the largest gaps seen, in ulps."""
    jc, tc = configs(arch, "f32")
    jp = jax_params(jc)
    toks, extra = prompt(jc.vocab), extras(jc)
    ref = jax_serve(jc, jp, toks, extra=extra)
    got = port_serve(tc, carry(tc, jp), toks, extra=extra)
    seen = {"logits": max(ulps(p, r) for p, r in zip(got["logits"], ref["logits"]))}
    assert got["logits"][0].shape == (B, jc.vocab)
    assert np.array_equal(np.stack(got["tokens"]), np.stack(ref["tokens"]))
    for when in ("prefill_caches", "caches"):
        assert len(got[when]) == len(ref[when]) == jc.n_layers
        for n, (pc, rc) in enumerate(zip(got[when], ref[when])):
            assert pc.keys() == rc.keys(), (when, n, pc.keys(), rc.keys())
            for name in pc:
                if name == "length":
                    assert pc[name] == rc[name], (when, n, pc[name], rc[name])
                    continue
                u = ulps(pc[name], rc[name])
                seen[name] = max(seen.get(name, 0.0), u)
                assert u <= tol_ulps, f"{when} layer {n} {name}: {u:.1f} ulps > {tol_ulps}"
    assert seen["logits"] <= tol_ulps, f"logits: {seen['logits']:.1f} ulps > {tol_ulps}"
    print(arch, {k: round(v, 2) for k, v in seen.items()})
    return seen


_STRICT = """
import sys
import numpy as np
sys.path.insert(0, "tests")
from _torch_lm import configs, extras, jax_params, jax_serve, prompt
jc, _ = configs(%r, "bf16")
r = jax_serve(jc, jax_params(jc), prompt(jc.vocab), extra=extras(jc))
np.savez(%r, logits=np.stack(r["logits"]), tokens=np.stack(r["tokens"]))
print("ok")
"""


def start_strict(arch: str, out):
    """JAX serving ``arch``'s bf16 smoke model with
    ``--xla_allow_excess_precision=false``, in the background (XLA reads its
    flags once per process); its logits and greedy tokens go to ``out``."""
    from _torch_port import start_with_devices

    return start_with_devices(_STRICT % (arch, str(out)), 1, strict_bf16=True)


def strict_fixture(arch: str):
    """A module fixture (autouse: it starts with the module's first test)
    running :func:`start_strict` for ``arch`` in the background; a test file
    binds it as ``strict = strict_fixture(ARCH)``."""
    @pytest.fixture(scope="module", autouse=True)
    def strict(tmp_path_factory):
        out = tmp_path_factory.mktemp(f"{arch}_strict") / "strict.npz"
        proc = start_strict(arch, out)
        yield proc, out
        proc.kill()

    return strict


def bf16_mode_gaps(arch: str, strict) -> dict:
    """The bf16 smoke model served by the port and by default-mode JAX, every
    decode fed strict JAX's greedy tokens (``strict``: the value of
    :func:`strict_fixture`): each one's largest logit gap to strict JAX, and
    the share of the port's logits equal to strict JAX's.  The port may be
    no further from strict JAX than default JAX is."""
    from _torch_port import finish

    proc, out = strict
    finish(proc)
    ref = np.load(out)
    jc, tc = configs(arch, "bf16")
    jp = jax_params(jc)
    toks, extra = prompt(jc.vocab), extras(jc)
    forced = ref["tokens"]
    default = jax_serve(jc, jp, toks, forced=forced, extra=extra)
    got = port_serve(tc, carry(tc, jp), toks, forced=forced, extra=extra)

    def gap(a, b):
        return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())

    port = np.stack(got["logits"])
    g = dict(port_gap=gap(port, ref["logits"]),
             mode_gap=gap(np.stack(default["logits"]), ref["logits"]),
             same=float((port == ref["logits"]).mean()))
    print(arch, g)
    assert g["mode_gap"] > 0, "strict and default JAX agree: the subprocess lost its flag"
    assert g["port_gap"] <= g["mode_gap"], g
    return g
