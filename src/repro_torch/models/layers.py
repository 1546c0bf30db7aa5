"""Shared NN layers: norms, RoPE, flash-style and decode attention,
activations and the training loss.

The port of ``repro/models/layers.py``.  Attention is written flash-style
(a loop over KV blocks with online-softmax f32 accumulators) exactly as the
JAX package writes it, so the working set stays bounded at long contexts and
the arithmetic rounds where the reference rounds:

- scores and ``p @ v`` take 16-bit operands with f32 outputs (the
  reference's ``preferred_element_type=jnp.float32``).  ``torch.einsum`` on
  bfloat16 tensors would round its output to bfloat16, so the operands are
  widened to float32 first: a product of two bfloat16 values is exact in
  float32, and the sums run in float32 as the reference's do;
- ``p`` is cast to the value dtype once per KV block, so the block size
  changes bfloat16 results and is kept;
- masked scores are ``NEG_INF = -1e30``, not ``-inf``, and padded keys of a
  ragged last block sit at position ``-10**9``, as in the reference (so
  without a window they pass the causal test and count, with score 0 and a
  zero value, in the softmax sum: the reference's arithmetic, kept).

There is no CUDA kernel here: the reference's attention is jnp code that
reaches no Pallas kernel.  ``F.scaled_dot_product_attention`` sums in
another order and rounds ``p`` elsewhere, and is not used.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def layernorm(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    c = xf - mu
    var = torch.mean(c * c, dim=-1, keepdim=True)
    return (c * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def groupnorm_heads(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                    eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm (RWKV's ln_x / GroupNorm over heads). x: (..., H, D);
    its eps is RWKV's 64e-5, not ``layernorm``'s 1e-5."""
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    c = xf - mu
    var = torch.mean(c * c, dim=-1, keepdim=True)
    return (c * torch.rsqrt(var + eps) * w + b).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (B, T, H, D) with D even; positions: (B, T) integers."""
    d = x.shape[-1]
    freqs = torch.pow(torch.tensor(theta, dtype=F32, device=x.device),
                      -torch.arange(0, d, 2, dtype=F32, device=x.device) / d)
    ang = positions[..., None].to(F32) * freqs                       # (B,T,D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Flash-style attention (train / prefill)
# ---------------------------------------------------------------------------

def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                window: int | None) -> torch.Tensor:
    """(Tq, Tk) boolean mask block from absolute positions."""
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def flash_attention(
    q: torch.Tensor,            # (B, Tq, K, G, D) grouped queries
    k: torch.Tensor,            # (B, Tk, K, D)
    v: torch.Tensor,            # (B, Tk, K, D)
    q_pos: torch.Tensor,        # (Tq,) absolute positions
    k_pos: torch.Tensor,        # (Tk,)
    *,
    causal: bool = True,
    window: int | None = None,
    block: int = 1024,
    softcap: float | None = None,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks; f32 stats and accumulators."""
    B, Tq, K, G, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    block = min(block, Tk)
    n_blocks = math.ceil(Tk / block)
    pad = n_blocks * block - Tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-(10 ** 9))

    qf = q.to(F32)
    o = torch.zeros((B, Tq, K, G, D), dtype=F32, device=q.device)
    m = torch.full((B, Tq, K, G), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((B, Tq, K, G), dtype=F32, device=q.device)
    for j in range(n_blocks):
        sl = slice(j * block, (j + 1) * block)
        kc, vc, pc = k[:, sl], v[:, sl], k_pos[sl]
        s = torch.einsum("btkgd,bskd->btkgs", qf, kc.to(F32)) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = _block_mask(q_pos, pc, causal=causal, window=window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("btkgs,bskd->btkgd", p.to(v.dtype).to(F32), vc.to(F32))
        o = o * corr[..., None] + pv
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.to(q.dtype)


def decode_attention(
    q: torch.Tensor,            # (B, 1, K, G, D)
    k_cache: torch.Tensor,      # (B, S, K, D)
    v_cache: torch.Tensor,
    cache_len: int,             # valid length, held on the host
    k_pos0: int = 0,            # absolute position of cache slot 0
    *,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Single-token attention over the cache: a masked global softmax in f32."""
    S = k_cache.shape[1]
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bokgd,bskd->bkgs", q.to(F32), k_cache.to(F32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = k_pos0 + torch.arange(S, device=q.device)
    valid = pos[None, :] < cache_len                              # (1, S)
    if window is not None:
        valid &= pos[None, :] > (cache_len - 1 - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pn = (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", pn.to(F32), v_cache.to(F32))
    return o[:, None].to(q.dtype)   # (B, 1, K, G, D)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``, in its order of operations."""
    c = math.sqrt(2 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate.to(F32)).to(up.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    return gelu_tanh(x.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                       *, z_loss: float = 1e-4) -> torch.Tensor:
    """Next-token cross-entropy, masked mean over tokens, plus ``z_loss`` x
    lse^2.  The logits (B, T, V) stay in their dtype: the max is exact in
    it and ``logits - m`` rounds in it, then ``exp`` and the sum run in
    f32, as in the reference.  The gold logit is a ``gather`` where the
    reference takes a one-hot einsum with f32 output: only one term of that
    sum is non-zero, so both give the logit itself and the same gradient
    (the upstream gradient, rounded to the logits' dtype, at the target)."""
    m = torch.amax(logits, dim=-1, keepdim=True)
    se = torch.sum(torch.exp((logits - m).to(F32)), dim=-1)
    lse = m[..., 0].to(F32) + torch.log(se)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0].to(F32)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = mask.to(F32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
