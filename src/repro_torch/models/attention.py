"""GQA attention block: projections + RoPE + flash/decode attention + cache.

The port of ``repro/models/attention.py``: grouped KV heads, QKV bias
(qwen2), sliding windows (gemma3's 5:1 local:global), prefix-LM masking
(paligemma), a logit softcap (grok) and cross-attention (whisper's decoder,
over K/V computed once from the encoder's output).

The cache is updated in place: prefill and decode write their keys and
values into the cache's buffers (the reference's ``dynamic_update_slice``,
which XLA also does in place) and return the cache with its new length.
The length is a Python int, so no decode step reads a device scalar back.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import decode_attention, flash_attention, rope
from repro_torch.models.param import ParamDef


@dataclasses.dataclass
class AttnCache:
    k: torch.Tensor       # (B, S, K, D)
    v: torch.Tensor       # (B, S, K, D)
    length: int           # number of valid positions (held on the host)


def init_cache(batch: int, max_len: int, n_kv: int, d_head: int,
               dtype=torch.bfloat16, device: str | torch.device | None = "cuda") -> AttnCache:
    device = resolve_device(device)
    return AttnCache(
        k=torch.zeros((batch, max_len, n_kv, d_head), dtype=dtype, device=device),
        v=torch.zeros((batch, max_len, n_kv, d_head), dtype=dtype, device=device),
        length=0,
    )


def build_params(d_model: int, n_heads: int, n_kv: int, d_head: int, *,
                 qkv_bias: bool = False, cross: bool = False, dtype=torch.bfloat16) -> dict:
    p = {
        "wq": ParamDef((d_model, n_heads, d_head), ("d_model", "heads", "head_dim"), dtype=dtype),
        "wk": ParamDef((d_model, n_kv, d_head), ("d_model", "kv_heads", "head_dim"), dtype=dtype),
        "wv": ParamDef((d_model, n_kv, d_head), ("d_model", "kv_heads", "head_dim"), dtype=dtype),
        "wo": ParamDef((n_heads, d_head, d_model), ("heads", "head_dim", "d_model"), dtype=dtype),
    }
    if qkv_bias:
        p["bq"] = ParamDef((n_heads, d_head), ("heads", "head_dim"), init="zeros", dtype=dtype)
        p["bk"] = ParamDef((n_kv, d_head), ("kv_heads", "head_dim"), init="zeros", dtype=dtype)
        p["bv"] = ParamDef((n_kv, d_head), ("kv_heads", "head_dim"), init="zeros", dtype=dtype)
    if cross:
        p["c_wq"] = ParamDef((d_model, n_heads, d_head), ("d_model", "heads", "head_dim"), dtype=dtype)
        p["c_wk"] = ParamDef((d_model, n_kv, d_head), ("d_model", "kv_heads", "head_dim"), dtype=dtype)
        p["c_wv"] = ParamDef((d_model, n_kv, d_head), ("d_model", "kv_heads", "head_dim"), dtype=dtype)
        p["c_wo"] = ParamDef((n_heads, d_head, d_model), ("heads", "head_dim", "d_model"), dtype=dtype)
    return p


def _project(x, w, b=None):
    out = torch.einsum("btd,dhe->bthe", x, w)
    return out + b[None, None] if b is not None else out


def self_attention(
    p,                                  # the attention module (leaves wq, wk, wv, wo[, bq, bk, bv])
    x: torch.Tensor,                    # (B, T, d)
    *,
    n_kv: int,
    mode: str,                          # "train" | "prefill" | "decode"
    cache: AttnCache | None = None,
    positions: torch.Tensor | None = None,  # (T,) absolute positions (train/prefill)
    causal: bool = True,
    window: int | None = None,
    prefix_len: int = 0,
    rope_theta: float | None = 1e4,
    softcap: float | None = None,
    block: int = 1024,
):
    """Returns (out (B,T,d), new_cache)."""
    B, T, d = x.shape
    H, Dh = p.wq.shape[1], p.wq.shape[2]
    G = H // n_kv
    q = _project(x, p.wq, getattr(p, "bq", None))
    k = _project(x, p.wk, getattr(p, "bk", None))
    v = _project(x, p.wv, getattr(p, "bv", None))

    if mode in ("train", "prefill"):
        if positions is None:
            positions = torch.arange(T, device=x.device)
        pos_b = positions[None].expand(B, T)
        if rope_theta is not None:
            q = rope(q, pos_b, rope_theta)
            k = rope(k, pos_b, rope_theta)
        qg = q.reshape(B, T, n_kv, G, Dh)
        if prefix_len > 0:
            # prefix-LM: bidirectional inside the prefix, causal after
            q_eff = torch.clamp(positions, min=prefix_len - 1)
        else:
            q_eff = positions
        o = flash_attention(qg, k, v, q_eff, positions, causal=causal,
                            window=window, softcap=softcap, block=block)
        new_cache = cache
        if mode == "prefill":
            assert cache is not None
            S = cache.k.shape[1]
            n = min(T, S)
            for buf, val in ((cache.k, k), (cache.v, v)):
                buf[:, :n] = val[:, :n]
                buf[:, n:] = 0
            new_cache = AttnCache(cache.k, cache.v, n)
        out = torch.einsum("bthe,hed->btd", o.reshape(B, T, H, Dh), p.wo)
        return out, new_cache

    # decode: T == 1, write into the cache then attend over the whole buffer
    assert cache is not None and T == 1
    pos = cache.length
    pos_b = torch.full((B, 1), pos, device=x.device)
    if rope_theta is not None:
        q = rope(q, pos_b, rope_theta)
        k = rope(k, pos_b, rope_theta)
    _ring_update(cache.k, k, pos)
    _ring_update(cache.v, v, pos)
    new_len = min(pos + 1, cache.k.shape[1])
    o = decode_attention(q.reshape(B, 1, n_kv, G, Dh), cache.k, cache.v,
                         cache_len=pos + 1, k_pos0=0, window=window, softcap=softcap)
    out = torch.einsum("bthe,hed->btd", o.reshape(B, 1, H, Dh), p.wo)
    return out, AttnCache(cache.k, cache.v, new_len)


def _ring_update(buf: torch.Tensor, val: torch.Tensor, pos: int) -> None:
    """Write one timestep into the cache at ``pos``, clamped to the last slot
    (a clamp, not a wrap, as in the reference)."""
    buf[:, min(pos, buf.shape[1] - 1)] = val[:, 0]


def cross_attention(
    p,                                   # the attention module (leaves c_wq, c_wo)
    x: torch.Tensor,                     # (B, T, d) decoder stream
    enc_kv: tuple[torch.Tensor, torch.Tensor],  # precomputed (k, v): (B, S_enc, K, Dh)
    *,
    n_kv: int,
    block: int = 1024,
) -> torch.Tensor:
    """Whisper-style cross attention (no masking, no rope)."""
    B, T, d = x.shape
    H, Dh = p.c_wq.shape[1], p.c_wq.shape[2]
    G = H // n_kv
    q = _project(x, p.c_wq).reshape(B, T, n_kv, G, Dh)
    k, v = enc_kv
    S = k.shape[1]
    o = flash_attention(q, k, v, torch.arange(T, device=x.device),
                        torch.arange(S, device=x.device), causal=False, block=block)
    return torch.einsum("bthe,hed->btd", o.reshape(B, T, H, Dh), p.c_wo)


def encode_cross_kv(p, enc_out: torch.Tensor):
    """Cross-attention K/V from the encoder's output (computed once, at prefill)."""
    return _project(enc_out, p.c_wk), _project(enc_out, p.c_wv)
