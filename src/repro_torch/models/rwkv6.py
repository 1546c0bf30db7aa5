"""RWKV-6 "Finch" time-mix / channel-mix (arXiv:2404.05892).

The port of ``repro/models/rwkv6.py``.  The WKV6 recurrence per head
(state S in R^{dk x dv}):

    o_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})
    S_t = diag(w_t) S_{t-1} + k_t v_t^T ,   w_t = exp(-exp(decay_t))

with data-dependent decay and data-dependent token-shift interpolation
(ddlerp).  Two evaluation orders, as in the reference:

* :func:`wkv_recurrent`: a step per token; the decode path and the oracle.
* :func:`wkv_chunked`: the chunk-parallel form (a within-chunk "attention"
  matrix plus a state carried across chunks); the prefill path.  Every
  chunk's own terms are computed for all chunks at once; only the carry of
  the state from chunk to chunk is a loop, of ``T / C`` steps.  The sums
  and products are the reference's, term for term.

f32 where the reference widens: the ddlerp and decay einsums, the WKV
state and both WKV forms, and the gates.  No kernel: the reference's WKV is
computed by XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import F32, groupnorm_heads, silu
from repro_torch.models.param import ParamDef

LORA_R = 32
DDLERP_R = 32


def build_params(d_model: int, head_size: int, d_ff: int, *, dtype=torch.bfloat16) -> dict:
    H = d_model // head_size
    return {
        # time-mix (token-shift) static lerps + data-dependent lora (5 mixes: r,k,v,w,g)
        "mu": ParamDef((5, d_model), (None, "d_model"), init="zeros", dtype=F32),
        "ddlerp_w1": ParamDef((d_model, 5, DDLERP_R), ("d_model", None, None), dtype=dtype),
        "ddlerp_w2": ParamDef((5, DDLERP_R, d_model), (None, None, "d_model"), dtype=dtype),
        # projections
        "w_r": ParamDef((d_model, d_model), ("d_model", "heads_flat"), dtype=dtype),
        "w_k": ParamDef((d_model, d_model), ("d_model", "heads_flat"), dtype=dtype),
        "w_v": ParamDef((d_model, d_model), ("d_model", "heads_flat"), dtype=dtype),
        "w_g": ParamDef((d_model, d_model), ("d_model", "heads_flat"), dtype=dtype),
        "w_o": ParamDef((d_model, d_model), ("heads_flat", "d_model"), dtype=dtype),
        # decay: w0 + tanh(x @ A) @ B   (data-dependent, per channel)
        "decay_base": ParamDef((d_model,), ("heads_flat",), init="zeros", dtype=F32),
        "decay_A": ParamDef((d_model, LORA_R), ("d_model", None), dtype=dtype),
        "decay_B": ParamDef((LORA_R, d_model), (None, "heads_flat"), dtype=dtype),
        # per-channel bonus u and output groupnorm
        "bonus": ParamDef((H, head_size), ("heads", "head_dim"), init="zeros", dtype=F32),
        "ln_x_w": ParamDef((H, head_size), ("heads", "head_dim"), init="ones", dtype=F32),
        "ln_x_b": ParamDef((H, head_size), ("heads", "head_dim"), init="zeros", dtype=F32),
        # channel-mix
        "cm_mu": ParamDef((2, d_model), (None, "d_model"), init="zeros", dtype=F32),
        "cm_k": ParamDef((d_model, d_ff), ("d_model", "ff"), dtype=dtype),
        "cm_v": ParamDef((d_ff, d_model), ("ff", "d_model"), dtype=dtype),
        "cm_r": ParamDef((d_model, d_model), ("d_model", "d_model"), dtype=dtype),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} stream; prev = last token of the previous segment (or zeros)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Data-dependent interpolation producing the 5 mixed inputs (r,k,v,w,g)."""
    dx = (x_prev - x).to(F32)
    inner = torch.tanh(torch.einsum("btd,dmr->btmr", dx, p.ddlerp_w1.to(F32)))
    lora = torch.einsum("btmr,mrd->btmd", inner, p.ddlerp_w2.to(F32))
    mix = p.mu[None, None] + lora                               # (B,T,5,d) f32
    return (x[:, :, None].to(F32) + dx[:, :, None] * mix).to(x.dtype)


def _project(p, x: torch.Tensor, x_prev: torch.Tensor, head_size: int):
    B, T, d = x.shape
    H = d // head_size
    mixed = _ddlerp(p, x, x_prev)                               # (B,T,5,d)
    xr, xk, xv, xw, xg = (mixed[:, :, i] for i in range(5))
    r = (xr @ p.w_r).reshape(B, T, H, head_size)
    k = (xk @ p.w_k).reshape(B, T, H, head_size)
    v = (xv @ p.w_v).reshape(B, T, H, head_size)
    g = silu((xg @ p.w_g).to(F32)).to(x.dtype)
    decay_in = torch.tanh(torch.einsum("btd,dr->btr", xw.to(F32), p.decay_A.to(F32)))
    logw = p.decay_base[None, None] + torch.einsum("btr,rd->btd", decay_in,
                                                   p.decay_B.to(F32))
    # w in (0,1): w = exp(-exp(logw)); keep log-decay = -exp(logw) (f32)
    log_decay = -torch.exp(torch.clamp(logw, -10.0, 6.0)).reshape(B, T, H, head_size)
    return r, k, v, g, log_decay


def wkv_recurrent(r, k, v, log_decay, bonus, state):
    """A step per token. r/k/v: (B,T,H,D); state: (B,H,D,D) f32. Returns (o, state)."""
    T = r.shape[1]
    S, outs = state, []
    for t in range(T):
        rt, kt, vt, ld = r[:, t].to(F32), k[:, t].to(F32), v[:, t].to(F32), log_decay[:, t]
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, S + bonus[None, :, :, None] * kv))
        S = torch.exp(ld)[..., None] * S + kv
    return torch.stack(outs, dim=1).to(r.dtype), S


def chunk_len(T: int, chunk: int) -> int:
    """The reference's chunk: ``min(chunk, T)`` halved until it divides T."""
    C = min(chunk, T)
    while T % C:
        C //= 2
    return C


#: the block of XLA's cumulative sum on the CPU (below)
CUMSUM_BLOCK = 16


def cumsum_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The inclusive cumulative sum along ``dim`` in the order XLA's CPU
    backend computes ``jnp.cumsum``: blocks of ``CUMSUM_BLOCK``, a sequential
    f32 chain inside each block, and each block offset by the sequential sum
    of the earlier blocks' totals.  A chunk's log-decay is summed over up to
    64 steps and then exponentiated (``exp(-P)``), so the order of this sum
    is what most of the chunked form's rounding follows; ``torch.cumsum``
    sums in double on the CPU and in a parallel order on the card.

    Kept for the parity test of ``wkv_chunked`` alone: in this order the
    chunked form is within 4 f32 ulps of JAX's (1.7 seen), and a fault of a
    few ulps in it would show; with ``torch.cumsum`` it is 4-31 ulps from
    JAX's, about as far as JAX's own is from the exact recurrence (up to 23).
    It does not bring the served model closer: the ``rwkv6_7b`` smoke
    model's prefill + 8 decodes are 50 ulps of max|logit| from JAX's in
    this order and 35 with ``torch.cumsum`` (both inside the test's 128).
    Its cost is about 20 small operations a layer in each prefill."""
    dim = dim % x.ndim
    C = x.shape[dim]
    nb = -(-C // CUMSUM_BLOCK)
    pad = nb * CUMSUM_BLOCK - C
    if pad:             # zeros after the end change no earlier prefix
        x = torch.cat([x, x.new_zeros(x.shape[:dim] + (pad,) + x.shape[dim + 1:])], dim)
    xb = x.unflatten(dim, (nb, CUMSUM_BLOCK))                  # (..., nb, 16, ...)
    run = [xb.select(dim + 1, 0)]
    for i in range(1, CUMSUM_BLOCK):
        run.append(run[-1] + xb.select(dim + 1, i))
    local = torch.stack(run, dim + 1)
    carry, offsets = None, [None]
    for b in range(nb - 1):
        tot = local.select(dim, b).select(dim, CUMSUM_BLOCK - 1)
        carry = tot if carry is None else carry + tot
        offsets.append(carry)
    out = torch.stack([local.select(dim, 0)] + [
        offsets[b].unsqueeze(dim) + local.select(dim, b) for b in range(1, nb)], dim)
    return out.flatten(dim, dim + 1).narrow(dim, 0, C)


def wkv_chunked(r, k, v, log_decay, bonus, state, *, chunk: int = 64):
    """Chunk-parallel WKV6, equal to the recurrence up to rounding (tested)."""
    B, T, H, D = r.shape
    C = chunk_len(T, chunk)
    n = T // C
    rs = lambda a: a.to(F32).reshape(B, n, C, H, D)             # (B,n,C,H,D)
    rb, kb, vb, ld = rs(r), rs(k), rs(v), rs(log_decay)
    P = cumsum_xla(ld, 2)                                       # inclusive log-decay prods
    Pm1 = P - ld                                                # exclusive (P_{t-1})
    r_dec = rb * torch.exp(Pm1)
    # within-chunk: A[t,s] = sum_k r_t[k] k_s[k] exp(Pm1_t - P_s)[k], s < t
    att = torch.einsum("bnthk,bnshk->bnhts", r_dec, kb * torch.exp(-P))
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device), diagonal=-1)
    att = torch.where(tri, att, 0.0)
    intra = torch.einsum("bnhts,bnshv->bnthv", att, vb)
    del att
    # state update: S_out = diag(exp(P_C)) S + sum_s diag(exp(P_C - P_s)) k_s v_s
    PC = P[:, :, -1:]                                           # (B,n,1,H,D)
    kv = torch.einsum("bnshk,bnshv->bnhkv", kb * torch.exp(PC - P), vb)
    decay = torch.exp(PC[:, :, 0])[..., None]                   # (B,n,H,D,1)
    s_in = []
    S = state
    for i in range(n):                                          # the carry across chunks
        s_in.append(S)
        S = decay[:, i] * S + kv[:, i]
    # cross-chunk: o_cross[t] = (r_t * exp(Pm1_t)) . S_in
    o = torch.einsum("bnthk,bnhkv->bnthv", r_dec, torch.stack(s_in, dim=1))
    o = o + intra
    # bonus diagonal term (s == t)
    o = o + (rb * bonus[None, None, None] * kb).sum(-1, keepdim=True) * vb
    return o.reshape(B, T, H, D).to(r.dtype), S


def time_mix(p, x: torch.Tensor, *, head_size: int, state=None, shift_prev=None,
             chunked: bool = True, chunk: int = 64):
    """Full RWKV6 time-mix block. Returns (out, (state, last_token))."""
    B, T, d = x.shape
    H = d // head_size
    if state is None:
        state = torch.zeros((B, H, head_size, head_size), dtype=F32, device=x.device)
    x_prev = _token_shift(x, shift_prev)
    r, k, v, g, log_decay = _project(p, x, x_prev, head_size)
    bonus = p.bonus.to(F32)
    if chunked and T > 1:
        o, state = wkv_chunked(r, k, v, log_decay, bonus, state, chunk=chunk)
    else:
        o, state = wkv_recurrent(r, k, v, log_decay, bonus, state)
    o = groupnorm_heads(p.ln_x_w, p.ln_x_b, o)
    o = (o.reshape(B, T, d) * g.reshape(B, T, d)) @ p.w_o
    return o, (state, x[:, -1:])


def channel_mix(p, x: torch.Tensor, *, shift_prev=None):
    """RWKV6 channel-mix (squared-ReLU FFN with token shift + receptance gate)."""
    x_prev = _token_shift(x, shift_prev)
    dx = (x_prev - x).to(F32)
    mu = p.cm_mu[None, None]                                    # (1,1,2,d)
    xk = (x.to(F32) + dx * mu[:, :, 0]).to(x.dtype)
    xr = (x.to(F32) + dx * mu[:, :, 1]).to(x.dtype)
    kk = torch.square(torch.relu((xk @ p.cm_k).to(F32))).to(x.dtype)
    rr = torch.sigmoid((xr @ p.cm_r).to(F32)).to(x.dtype)
    return rr * (kk @ p.cm_v), x[:, -1:]
