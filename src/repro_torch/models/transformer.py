"""Architecture assembly: configs, parameter and cache trees, the model module.

The port of ``repro/models/transformer.py`` for every layer kind of the JAX
package: attention (``attn``, with a dense MLP or a routed Mixture-of-Experts,
``models/moe.py``, and optionally cross-attention), Mamba (``mamba``,
``models/mamba.py``, with the same MLP or MoE half) and RWKV-6 (``rwkv``,
``models/rwkv6.py``: time-mix and channel-mix, no MLP); the encoder-decoder
(whisper: a non-causal encoder stack ``enc_layers`` whose output the
decoder's cross-attention reads) and the VLM prefix (paligemma: patch
embeddings prepended to the token embeddings, attended to bidirectionally).
The JAX package scans a *period* of layer
kinds over ``n_periods`` and stacks each period position's parameters as
``layers/pos{i}`` with a leading ``n_periods`` axis, so that position ``i``
of period ``p`` is layer ``p * len(period) + i``.  The defs trees here keep
that stacked layout (for counts, shapes and carrying JAX weights across);
:class:`DecoderLM` unstacks it into one :class:`Block` per layer, in that
layer order, in an ``nn.ModuleList``, and ``stack_apply`` is a Python loop
over them.  Caches are a list with one entry per layer in the same order:
``{"attn": AttnCache}`` (plus ``cross_k``/``cross_v`` under cross-attention),
``{"ssm", "conv"}`` for Mamba and ``{"wkv", "tm_shift", "cm_shift"}`` for
RWKV.  The steps write the attention caches and the recurrent states in
place; prefill *replaces* ``cross_k``/``cross_v`` with the encoder's K/V,
whose length is the frames', as the reference does.

Training reads the stacked tree itself, not a :class:`DecoderLM`: its
leaves are the trainable tensors, leaf for leaf the reference's (the global
norm, the per-leaf compression scales and the checkpoints all walk that
layout).  :func:`model_view` gives the forward the same attribute surface
over it, each layer's leaves slices of the stacked tensors (``unbind``), so
autograd sums every layer's gradient into its slice of one stacked
gradient.  With ``cfg.remat`` each block of a training forward runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are recomputed
in the backward, as ``jax.checkpoint`` recomputes the reference's scan body.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, mamba, moe, rwkv6
from repro_torch.models.layers import layernorm, rmsnorm
from repro_torch.models.param import ParamDef, constrain, map_tree, map_trees, stack_defs


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
    remat: bool = True              # training: recompute each block in the backward
    dtype: Any = torch.bfloat16
    # lowering/compile shape knobs of the JAX package (kept so configs compare
    # field by field; serving here reads attn_block and rwkv_chunk)
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


#: the encoder's layer (whisper): bidirectional self-attention and the MLP
ENC_SPEC = LayerSpec(kind="attn", causal=False)


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
    d: dict = {"ln1": _norm_defs(cfg)}
    if spec.kind == "attn":
        d["attn"] = attention.build_params(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            qkv_bias=cfg.qkv_bias, cross=spec.cross, dtype=cfg.dtype)
        if spec.cross:
            d["ln_c"] = _norm_defs(cfg)
    elif spec.kind == "mamba":
        d["mamba"] = mamba.build_params(
            cfg.d_model, d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
            expand=cfg.mamba_expand, dtype=cfg.dtype)
    elif spec.kind == "rwkv":
        d["rwkv"] = rwkv6.build_params(cfg.d_model, cfg.rwkv_head_size, cfg.d_ff,
                                       dtype=cfg.dtype)
        d["ln2"] = _norm_defs(cfg)
        return d
    else:
        raise ValueError(spec.kind)
    d["ln2"] = _norm_defs(cfg)
    if spec.moe:
        d["moe"] = moe.build_params(cfg.d_model, cfg.n_experts, cfg.d_ff_expert,
                                    n_shared=cfg.n_shared_experts, dtype=cfg.dtype)
    else:
        d["mlp"] = moe.build_dense_params(cfg.d_model, cfg.d_ff, act=cfg.act, dtype=cfg.dtype)
    return d


def build_model_defs(cfg: ArchConfig) -> dict:
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
    if cfg.enc_dec:
        defs["enc_layers"] = {
            "pos0": stack_defs(build_layer_defs(cfg, ENC_SPEC), cfg.n_enc_layers)
        }
        defs["enc_norm"] = _norm_defs(cfg)
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
    """One layer's parameters and its spec: ``ln1``, then ``attn`` (and
    ``ln_c`` under cross-attention) or ``mamba``, then ``ln2`` and ``mlp``
    or ``moe``; or, for RWKV, ``ln1``, ``rwkv`` and ``ln2`` (no MLP)."""

    def __init__(self, tree: dict, spec: LayerSpec):
        super().__init__(tree)
        self.spec = spec


class DecoderLM(ParamTree):
    """The whole model: ``embed``, ``final_norm``, optionally ``lm_head``,
    ``layers``, one :class:`Block` per layer in layer order, and for an
    encoder-decoder ``enc_layers`` (one per encoder layer) and ``enc_norm``."""

    def __init__(self, top: dict, blocks: list[Block], enc_blocks: list[Block] | None = None):
        super().__init__(top)
        self.layers = nn.ModuleList(blocks)
        if enc_blocks is not None:
            self.enc_layers = nn.ModuleList(enc_blocks)

    @classmethod
    def from_tree(cls, cfg: ArchConfig, tree: dict) -> DecoderLM:
        """The stacked tree of ``build_model_defs``'s layout (tensors), with
        ``layers/pos{i}`` unstacked so that position ``i`` of period ``p``
        becomes block ``p * len(period) + i`` (and ``enc_layers/pos0`` into
        one block per encoder layer).  Blocks hold views of the stacked
        tensors: nothing is copied."""
        blocks = []
        for p in range(cfg.n_periods):
            for i, spec in enumerate(cfg.period):
                stacked = tree["layers"][f"pos{i}"]
                blocks.append(Block(_index(stacked, p), spec))
        enc_blocks = None
        if cfg.enc_dec:
            enc_blocks = [Block(_index(tree["enc_layers"]["pos0"], n), ENC_SPEC)
                          for n in range(cfg.n_enc_layers)]
        top = {k: v for k, v in tree.items() if k not in ("layers", "enc_layers")}
        return cls(top, blocks, enc_blocks)


def _index(tree: dict, p: int) -> dict:
    return {k: _index(v, p) if isinstance(v, dict) else v[p] for k, v in tree.items()}


class TreeView:
    """A nested dict of tensors read by attribute (``p.attn.wq``), as the
    blocks of :class:`DecoderLM` are read, holding the tensors themselves:
    a ``Parameter`` made from a slice would be a new leaf, and no gradient
    would reach the stacked tensor.  ``spec``: a layer's :class:`LayerSpec`."""

    def __init__(self, tree: dict, spec: LayerSpec | None = None):
        for k, v in tree.items():
            setattr(self, k, TreeView(v) if isinstance(v, dict) else v)
        if spec is not None:
            self.spec = spec


def _unstack(stacked: dict, period: tuple[LayerSpec, ...], n: int) -> list[TreeView]:
    """One view per layer, in layer order (position ``i`` of period ``p`` is
    layer ``p * len(period) + i``), each leaf a slice of its stacked tensor."""
    views = []
    slices = [map_tree(lambda t: t.unbind(0), stacked[f"pos{i}"]) for i in range(len(period))]
    for p in range(n):
        for i, spec in enumerate(period):
            views.append(TreeView(map_trees(lambda _, u: u[p], stacked[f"pos{i}"], slices[i]),
                                  spec))
    return views


def model_view(cfg: ArchConfig, tree: dict) -> TreeView:
    """The model of a stacked parameter tree (``build_model_defs``'s layout):
    the attribute surface of :class:`DecoderLM` (``embed``, ``final_norm``,
    ``lm_head``, ``layers``, ``enc_layers``, ``enc_norm``) over the tree's
    own tensors, so a forward through it is differentiable in them."""
    view = TreeView({k: v for k, v in tree.items() if k not in ("layers", "enc_layers")})
    view.layers = _unstack(tree["layers"], cfg.period, cfg.n_periods)
    if cfg.enc_dec:
        view.enc_layers = _unstack(tree["enc_layers"], (ENC_SPEC,), cfg.n_enc_layers)
    return view


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _layer_cache_defs(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int,
                      enc_len: int) -> Any:
    if spec.kind == "attn":
        kv = ParamDef((batch, max_len, cfg.n_kv_heads, cfg.d_head),
                      ("batch", "kv_seq", "kv_heads", "head_dim"), init="zeros", dtype=cfg.dtype)
        c = {"attn": attention.AttnCache(
            k=kv, v=kv, length=ParamDef((), (), init="zeros", dtype=torch.int32))}
        if spec.cross:
            ckv = ParamDef((batch, enc_len, cfg.n_kv_heads, cfg.d_head),
                           ("batch", None, "kv_heads", "head_dim"), init="zeros", dtype=cfg.dtype)
            c["cross_k"] = c["cross_v"] = ckv
        return c
    if spec.kind == "mamba":
        d_inner = cfg.mamba_expand * cfg.d_model
        return {
            "ssm": ParamDef((batch, d_inner, cfg.mamba_d_state),
                            ("batch", "heads_flat", "state"), init="zeros", dtype=torch.float32),
            "conv": ParamDef((batch, cfg.mamba_d_conv - 1, d_inner),
                             ("batch", None, "heads_flat"), init="zeros", dtype=cfg.dtype),
        }
    if spec.kind == "rwkv":
        H = cfg.d_model // cfg.rwkv_head_size
        shift = ParamDef((batch, 1, cfg.d_model), ("batch", None, None), init="zeros",
                         dtype=cfg.dtype)
        return {
            "wkv": ParamDef((batch, H, cfg.rwkv_head_size, cfg.rwkv_head_size),
                            ("batch", "heads", None, None), init="zeros", dtype=torch.float32),
            "tm_shift": shift,
            "cm_shift": shift,
        }
    raise ValueError(spec.kind)


def build_cache_defs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The reference's cache layout (``pos{i}`` stacked over periods), as
    defs: for shapes and dtypes only.  At run time each layer has its own
    cache, one period slice of these (``model.init_caches``)."""
    enc_len = cfg.enc_len_decode if cfg.enc_dec else 0
    return {
        f"pos{i}": stack_defs(_layer_cache_defs(cfg, s, batch, max_len, enc_len), cfg.n_periods)
        for i, s in enumerate(cfg.period)
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def apply_layer(cfg: ArchConfig, spec: LayerSpec, p: Block, x: torch.Tensor, *,
                mode: str, cache: dict | None, positions, enc_out=None, prefix_len: int = 0):
    """One block. Returns (x, new_cache, aux): ``aux`` is the MoE layer's
    load-balancing loss (0.0 for a dense MLP and for RWKV)."""
    new_cache = dict(cache) if cache is not None else None
    x = constrain(x, ("batch", "seq" if mode == "decode" else "seq_act", "d_model"))
    if spec.kind == "attn":
        h = _apply_norm(cfg, p.ln1, x)
        o, ac = attention.self_attention(
            p.attn, h, n_kv=cfg.n_kv_heads, mode=mode,
            cache=cache["attn"] if cache else None, positions=positions,
            causal=spec.causal, window=spec.window, prefix_len=prefix_len,
            rope_theta=cfg.rope_theta, softcap=cfg.attn_softcap, block=cfg.attn_block)
        x = x + o
        if new_cache is not None:
            new_cache["attn"] = ac
        if spec.cross:
            hc = _apply_norm(cfg, p.ln_c, x)
            if mode == "decode":
                enc_kv = (cache["cross_k"], cache["cross_v"])
            else:
                enc_kv = attention.encode_cross_kv(p.attn, enc_out)
                if new_cache is not None:       # replaced: the frames' length, not enc_len
                    new_cache["cross_k"], new_cache["cross_v"] = (t.to(cfg.dtype) for t in enc_kv)
            x = x + attention.cross_attention(p.attn, hc, enc_kv, n_kv=cfg.n_kv_heads,
                                              block=cfg.attn_block)
    elif spec.kind == "mamba":
        h = _apply_norm(cfg, p.ln1, x)
        if mode == "decode":
            o, (ssm, conv) = mamba.mamba_decode(p.mamba, h, cache["ssm"], cache["conv"])
        else:   # the reference's prefill starts from zero state, whatever the cache holds
            o, (ssm, conv) = mamba.mamba_apply(p.mamba, h)
        x = x + o
        if new_cache is not None:
            new_cache["ssm"].copy_(ssm)
            new_cache["conv"].copy_(conv)
    elif spec.kind == "rwkv":
        h = _apply_norm(cfg, p.ln1, x)
        o, (wkv, tm_shift) = rwkv6.time_mix(
            p.rwkv, h, head_size=cfg.rwkv_head_size,
            state=cache["wkv"] if cache else None,
            shift_prev=cache["tm_shift"] if cache else None,
            chunked=(mode != "decode"), chunk=cfg.rwkv_chunk)
        x = x + o
        h = _apply_norm(cfg, p.ln2, x)
        o, cm_shift = rwkv6.channel_mix(p.rwkv, h,
                                        shift_prev=cache["cm_shift"] if cache else None)
        if new_cache is not None:
            new_cache["wkv"].copy_(wkv)
            new_cache["tm_shift"].copy_(tm_shift)
            new_cache["cm_shift"].copy_(cm_shift)
        return x + o, new_cache, 0.0
    else:
        raise ValueError(spec.kind)

    # MLP / MoE half (attn and mamba kinds)
    h = _apply_norm(cfg, p.ln2, x)
    aux = 0.0
    if spec.moe:
        o, aux = moe.moe_apply(p.moe, h, n_experts=cfg.n_experts, top_k=cfg.top_k,
                               group_size=cfg.moe_group_size, dispatch=cfg.moe_dispatch)
    else:
        o = moe.dense_apply(p.mlp, h, act=cfg.act)
    return x + o, new_cache, aux


def _train_block(cfg: ArchConfig, blk, x: torch.Tensor, positions, enc_out, prefix_len: int):
    x, _, aux = apply_layer(cfg, blk.spec, blk, x, mode="train", cache=None,
                            positions=positions, enc_out=enc_out, prefix_len=prefix_len)
    return x, aux


def stack_apply(cfg: ArchConfig, layers, x: torch.Tensor, *, mode: str,
                caches: list | None, positions, enc_out=None, prefix_len: int = 0):
    """Every block in layer order. Returns (x, new_caches, aux).  A training
    forward that records gradients runs each block under a non-reentrant
    ``checkpoint`` when ``cfg.remat`` is set."""
    if cfg.remat and mode == "train" and torch.is_grad_enabled():
        aux = 0.0
        for blk in layers:
            x, a = checkpoint(_train_block, cfg, blk, x, positions, enc_out, prefix_len,
                              use_reentrant=False)
            aux = aux + a
        return x, None, aux
    new_caches = [] if caches is not None else None
    aux = 0.0
    for n, blk in enumerate(layers):
        x, nc, a = apply_layer(cfg, blk.spec, blk, x, mode=mode,
                               cache=caches[n] if caches is not None else None,
                               positions=positions, enc_out=enc_out, prefix_len=prefix_len)
        if new_caches is not None:
            new_caches.append(nc)
        aux = aux + a
    return x, new_caches, aux


def apply_head(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final-norm'd hidden -> logits (tied or untied head); ``params``: a
    :class:`DecoderLM` or a :func:`model_view`."""
    head = getattr(params, "lm_head", None)
    if head is None:
        return torch.einsum("btd,vd->btv", x, params.embed)
    return torch.einsum("btd,dv->btv", x, head)


def forward(cfg: ArchConfig, params, batch: dict, *, mode: str,
            caches: list | None = None, return_logits: bool = True):
    """Unified forward. Returns (logits_or_hidden, new_caches, aux).

    ``params``: a :class:`DecoderLM` (serving) or the :func:`model_view` of
    a stacked tree (training).  batch keys: tokens (B,T) for train/prefill;
    token (B,1) for decode; + patch_embeds (B,P,d) for vlm; + frames
    (B,S_enc,d) for the encoder-decoder.  ``return_logits=False`` returns
    the final-norm'd hidden states.
    """
    embed = params.embed

    def embed_tokens(t):
        x = embed[t]
        if cfg.scale_embed:
            s = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
            x = x * s.to(x.dtype).to(x.device)
        return x

    enc_out = None
    prefix_len = 0
    if cfg.enc_dec and mode != "decode":
        enc = batch["frames"].to(cfg.dtype)
        enc, _, _ = stack_apply(cfg, params.enc_layers, enc, mode="train", caches=None,
                                positions=torch.arange(enc.shape[1], device=enc.device))
        enc_out = _apply_norm(cfg, params.enc_norm, enc)

    if mode == "decode":
        x = embed_tokens(batch["token"])
        positions = None
    else:
        x = embed_tokens(batch["tokens"])
        if cfg.frontend == "vlm":
            # after the token embedding's scale: the patches are not scaled
            pe = batch["patch_embeds"].to(cfg.dtype)
            x = torch.cat([pe, x], dim=1)
            prefix_len = pe.shape[1]
        positions = torch.arange(x.shape[1], device=x.device)

    x, new_caches, aux = stack_apply(cfg, params.layers, x, mode=mode, caches=caches,
                                     positions=positions, enc_out=enc_out,
                                     prefix_len=prefix_len)
    x = _apply_norm(cfg, params.final_norm, x)
    if not return_logits:
        return x, new_caches, aux
    return apply_head(cfg, params, x), new_caches, aux
