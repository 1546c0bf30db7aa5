"""Helpers for the LM serving parity tests (``tests/test_torch_lm_*.py``).

Both packages serve the same weights (the JAX package's ``init_params``,
carried across with ``params_from_numpy``) and the same prompts (numpy, from
a seed): a prefill of B x T tokens, then decode steps fed either each side's
own greedy token or a given token sequence.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# one intra-op thread per test process (see tests/_torch_port.py)
torch.set_num_threads(1)

B, T, STEPS = 2, 32, 8
ARCHS = ["qwen2_1_5b", "deepseek_7b", "stablelm_12b", "gemma3_12b"]
#: the routed-MoE decoder (its serving tests: test_torch_lm_moe.py)
MOE_ARCHS = ["qwen2_moe_a2_7b"]
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


def ref_layer_caches(jc, tree) -> list[dict]:
    """The reference's stacked cache tree as one ``{k, v, length}`` per layer,
    in layer order (period position ``i`` of period ``p`` is layer
    ``p * len(period) + i``)."""
    out = []
    for p in range(jc.n_periods):
        for i in range(len(jc.period)):
            c = tree[f"pos{i}"]["attn"]
            out.append(dict(k=np.asarray(c.k[p]).astype(np.float32),
                            v=np.asarray(c.v[p]).astype(np.float32),
                            length=int(np.asarray(c.length)[p])))
    return out


def port_layer_caches(caches) -> list[dict]:
    from repro_torch.device import tensor_to_numpy

    # copies: the port writes its cache buffers in place at every step
    return [dict(k=tensor_to_numpy(c["attn"].k).copy(), v=tensor_to_numpy(c["attn"].v).copy(),
                 length=c["attn"].length) for c in caches]


def jax_serve(jc, jp, toks: np.ndarray, steps: int = STEPS, max_len: int | None = None,
              forced: np.ndarray | None = None) -> dict:
    """Prefill + ``steps`` decodes through ``jax.jit`` of the reference's steps.
    Returns the last-position logits of every step (f32 numpy), the tokens fed
    to the decodes, and the caches after prefill and after the last step."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM

    b, t = toks.shape
    caches = JM.init_caches(jc, b, max_len or t + steps)
    prefill = jax.jit(JM.make_prefill_step(jc, JM.SHAPES["smoke_prefill"]))
    serve = jax.jit(JM.make_serve_step(jc))
    logits, caches = prefill(jp, {"tokens": jnp.asarray(toks)}, caches)
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
               forced: np.ndarray | None = None) -> dict:
    """``jax_serve`` through the port's steps on the CPU."""
    import torch

    from repro_torch.device import tensor_to_numpy
    from repro_torch.models import model as TM

    b, t = toks.shape
    caches = TM.init_caches(tc, b, max_len or t + steps, device="cpu")
    prefill = TM.make_prefill_step(tc, TM.SHAPES["smoke_prefill"])
    serve = TM.make_serve_step(tc)
    logits, caches = prefill(tp, {"tokens": torch.from_numpy(toks).long()}, caches)
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
