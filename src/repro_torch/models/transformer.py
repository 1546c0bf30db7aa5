"""Architecture assembly: configs, parameter and cache trees, the model module.

The port of ``repro/models/transformer.py`` for the decoder family of
kind ``attn``, with a dense MLP or a routed Mixture-of-Experts
(``models/moe.py``).  The JAX package scans a *period* of layer
kinds over ``n_periods`` and stacks each period position's parameters as
``layers/pos{i}`` with a leading ``n_periods`` axis, so that position ``i``
of period ``p`` is layer ``p * len(period) + i``.  The defs trees here keep
that stacked layout (for counts, shapes and carrying JAX weights across);
:class:`DecoderLM` unstacks it into one :class:`Block` per layer, in that
layer order, in an ``nn.ModuleList``, and ``stack_apply`` is a Python loop
over them.  Caches are a list with one entry per layer in the same order.

Mamba, RWKV and cross-attention layers, the encoder-decoder and the VLM
prefix are not ported yet: they raise ``NotImplementedError`` naming
ROADMAP §1.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.models import attention, moe
from repro_torch.models.layers import layernorm, rmsnorm
from repro_torch.models.param import ParamDef, constrain, stack_defs

NOT_PORTED = "is not ported yet (ROADMAP §1 lists the LM slices still to come)"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"              # attn | mamba | rwkv
    window: int | None = None       # sliding-window width (attn only)
    moe: bool = False               # MoE MLP instead of dense
    cross: bool = False             # + cross-attention (whisper decoder)
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    period: tuple[LayerSpec, ...] = (LayerSpec(),)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_group_size: int = 2048
    moe_dispatch: str = "einsum"    # einsum (GSPMD-clean) | scatter (baseline)
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 1e4
    attn_softcap: float | None = None
    # SSM / RWKV
    rwkv_head_size: int = 64
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # structure
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str | None = None     # vlm | audio
    n_frontend_tokens: int = 256
    enc_len_decode: int = 1500      # whisper: frozen encoder frames at decode
    tie_embeddings: bool = True
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    scale_embed: bool = False       # gemma-style sqrt(d) embedding scale
    remat: bool = True              # training only: no meaning when serving
    dtype: Any = torch.bfloat16
    # lowering/compile shape knobs of the JAX package (kept so configs compare
    # field by field; serving here reads only attn_block)
    unroll: bool = False
    attn_block: int = 1024          # flash-attention KV block size
    rwkv_chunk: int = 64
    inner_unroll: bool = False
    rules: tuple = ()

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.period) == 0, (self.name, self.n_layers, len(self.period))
        return self.n_layers // len(self.period)

    @property
    def sub_quadratic(self) -> bool:
        """True iff NO layer does full-context quadratic attention (long_500k gate)."""
        return all(s.kind != "attn" or s.window is not None for s in self.period)

    @property
    def has_decoder(self) -> bool:
        return True

    def layer_specs(self) -> list[LayerSpec]:
        """Each layer's spec, in layer order (position ``i`` of period ``p`` is
        layer ``p * len(period) + i``)."""
        return [s for _ in range(self.n_periods) for s in self.period]


def _check_ported(cfg: ArchConfig, spec: LayerSpec | None = None) -> None:
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder {NOT_PORTED}")
    if cfg.frontend == "vlm":
        raise NotImplementedError(f"{cfg.name}: the VLM prefix {NOT_PORTED}")
    for s in ([spec] if spec is not None else cfg.period):
        if s.kind != "attn":
            raise NotImplementedError(f"{cfg.name}: layer kind {s.kind!r} {NOT_PORTED}")
        if s.cross:
            raise NotImplementedError(f"{cfg.name}: cross-attention {NOT_PORTED}")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _norm_defs(cfg: ArchConfig) -> dict:
    d = {"w": ParamDef((cfg.d_model,), ("d_model",), init="ones", dtype=torch.float32)}
    if cfg.norm == "layernorm":
        d["b"] = ParamDef((cfg.d_model,), ("d_model",), init="zeros", dtype=torch.float32)
    return d


def _apply_norm(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(p.w, p.b, x)
    return rmsnorm(p.w, x)


def build_layer_defs(cfg: ArchConfig, spec: LayerSpec) -> dict:
    _check_ported(cfg, spec)
    d = {
        "ln1": _norm_defs(cfg),
        "attn": attention.build_params(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                       qkv_bias=cfg.qkv_bias, dtype=cfg.dtype),
        "ln2": _norm_defs(cfg),
    }
    if spec.moe:
        d["moe"] = moe.build_params(cfg.d_model, cfg.n_experts, cfg.d_ff_expert,
                                    n_shared=cfg.n_shared_experts, dtype=cfg.dtype)
    else:
        d["mlp"] = moe.build_dense_params(cfg.d_model, cfg.d_ff, act=cfg.act, dtype=cfg.dtype)
    return d


def build_model_defs(cfg: ArchConfig) -> dict:
    _check_ported(cfg)
    defs: dict = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "d_model"),
                          init="embed", dtype=cfg.dtype),
        "final_norm": _norm_defs(cfg),
        "layers": {
            f"pos{i}": stack_defs(build_layer_defs(cfg, s), cfg.n_periods)
            for i, s in enumerate(cfg.period)
        },
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), ("d_model", "vocab"),
                                   dtype=cfg.dtype)
    return defs


# ---------------------------------------------------------------------------
# The model as modules
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict of tensors as a module: tensors become frozen parameters
    and dicts submodules, under the same names (``ln1.w``, ``attn.wq``...)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))


class Block(ParamTree):
    """One decoder layer's parameters (``ln1``, ``attn``, ``ln2``, and
    ``mlp`` or ``moe``) and its spec."""

    def __init__(self, tree: dict, spec: LayerSpec):
        super().__init__(tree)
        self.spec = spec


class DecoderLM(ParamTree):
    """The whole model: ``embed``, ``final_norm``, optionally ``lm_head``, and
    ``layers``, one :class:`Block` per layer in layer order."""

    def __init__(self, top: dict, blocks: list[Block]):
        super().__init__(top)
        self.layers = nn.ModuleList(blocks)

    @classmethod
    def from_tree(cls, cfg: ArchConfig, tree: dict) -> DecoderLM:
        """The stacked tree of ``build_model_defs``'s layout (tensors), with
        ``layers/pos{i}`` unstacked so that position ``i`` of period ``p``
        becomes block ``p * len(period) + i``.  Blocks hold views of the
        stacked tensors: nothing is copied."""
        _check_ported(cfg)
        blocks = []
        for p in range(cfg.n_periods):
            for i, spec in enumerate(cfg.period):
                stacked = tree["layers"][f"pos{i}"]
                blocks.append(Block(_index(stacked, p), spec))
        top = {k: v for k, v in tree.items() if k != "layers"}
        return cls(top, blocks)


def _index(tree: dict, p: int) -> dict:
    return {k: _index(v, p) if isinstance(v, dict) else v[p] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _layer_cache_defs(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int) -> Any:
    _check_ported(cfg, spec)
    kv = ParamDef((batch, max_len, cfg.n_kv_heads, cfg.d_head),
                  ("batch", "kv_seq", "kv_heads", "head_dim"), init="zeros", dtype=cfg.dtype)
    return {"attn": attention.AttnCache(
        k=kv, v=kv, length=ParamDef((), (), init="zeros", dtype=torch.int32))}


def build_cache_defs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The reference's cache layout (``pos{i}`` stacked over periods), as
    defs: for shapes and dtypes only.  At run time each layer has its own
    cache, one period slice of these (``model.init_caches``)."""
    return {
        f"pos{i}": stack_defs(_layer_cache_defs(cfg, s, batch, max_len), cfg.n_periods)
        for i, s in enumerate(cfg.period)
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def apply_layer(cfg: ArchConfig, spec: LayerSpec, p: Block, x: torch.Tensor, *,
                mode: str, cache: dict | None, positions, prefix_len: int = 0):
    """One block. Returns (x, new_cache, aux): ``aux`` is the MoE layer's
    load-balancing loss (0.0 for a dense MLP)."""
    new_cache = dict(cache) if cache is not None else None
    x = constrain(x, ("batch", "seq" if mode == "decode" else "seq_act", "d_model"))
    h = _apply_norm(cfg, p.ln1, x)
    o, ac = attention.self_attention(
        p.attn, h, n_kv=cfg.n_kv_heads, mode=mode,
        cache=cache["attn"] if cache else None, positions=positions,
        causal=spec.causal, window=spec.window, prefix_len=prefix_len,
        rope_theta=cfg.rope_theta, softcap=cfg.attn_softcap, block=cfg.attn_block)
    x = x + o
    if new_cache is not None:
        new_cache["attn"] = ac
    h = _apply_norm(cfg, p.ln2, x)
    aux = 0.0
    if spec.moe:
        o, aux = moe.moe_apply(p.moe, h, n_experts=cfg.n_experts, top_k=cfg.top_k,
                               group_size=cfg.moe_group_size, dispatch=cfg.moe_dispatch)
    else:
        o = moe.dense_apply(p.mlp, h, act=cfg.act)
    return x + o, new_cache, aux


def stack_apply(cfg: ArchConfig, layers: nn.ModuleList, x: torch.Tensor, *, mode: str,
                caches: list | None, positions, prefix_len: int = 0):
    """Every block in layer order. Returns (x, new_caches, aux)."""
    new_caches = [] if caches is not None else None
    aux = 0.0
    for n, blk in enumerate(layers):
        x, nc, a = apply_layer(cfg, blk.spec, blk, x, mode=mode,
                               cache=caches[n] if caches is not None else None,
                               positions=positions, prefix_len=prefix_len)
        if new_caches is not None:
            new_caches.append(nc)
        aux = aux + a
    return x, new_caches, aux


def apply_head(cfg: ArchConfig, params: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    """Final-norm'd hidden -> logits (tied or untied head)."""
    head = getattr(params, "lm_head", None)
    if head is None:
        return torch.einsum("btd,vd->btv", x, params.embed)
    return torch.einsum("btd,dv->btv", x, head)


def forward(cfg: ArchConfig, params: DecoderLM, batch: dict, *, mode: str,
            caches: list | None = None, return_logits: bool = True):
    """Unified forward. Returns (logits_or_hidden, new_caches, aux).

    batch keys: tokens (B,T) for train/prefill; token (B,1) for decode.
    ``return_logits=False`` returns the final-norm'd hidden states.
    """
    embed = params.embed

    def embed_tokens(t):
        x = embed[t]
        if cfg.scale_embed:
            s = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
            x = x * s.to(x.dtype).to(x.device)
        return x

    if mode == "decode":
        x = embed_tokens(batch["token"])
        positions = None
    else:
        x = embed_tokens(batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)

    x, new_caches, aux = stack_apply(cfg, params.layers, x, mode=mode, caches=caches,
                                     positions=positions)
    x = _apply_norm(cfg, params.final_norm, x)
    if not return_logits:
        return x, new_caches, aux
    return apply_head(cfg, params, x), new_caches, aux
