"""Mixture-of-Experts with group-aligned capacity dispatch, and the dense MLP.

The port of ``repro/models/moe.py``.  Tokens are cut into groups of
``g = min(group_size, n_tok)`` (halved until it divides ``n_tok``); within a
group each token's router picks its top-k experts, and each expert takes at
most ``capacity(g, E, k)`` tokens into its buffer; a token beyond an
expert's capacity is dropped from that expert (it keeps its residual).
Every expert runs its SwiGLU FFN on its whole capacity buffer, so a decode
step reads every expert's weights.

:func:`moe_apply` is :func:`route` (the router in f32: logits, softmax, the
top-k weights and experts, the load-balancing loss) followed by one of the
two dispatches, so that a test can hand the JAX package's routing to the
port's dispatch:

* :func:`einsum_dispatch` (``dispatch="einsum"``, the reference's default):
  GShard's one-hot ``(n, g, E, cap)`` dispatch and combine masks, capacity
  positions assigned choice rank by choice rank, the buffers and the
  combine as einsums;
* :func:`scatter_dispatch` (``dispatch="scatter"``): capacity positions
  token by token, the buffer written with ``index_put_`` (the kept
  positions are unique, so it is deterministic), and each token's k
  weighted expert outputs summed in choice order with a bfloat16 rounding
  after each add, as the reference's ``.at[tok].add`` sums them (CUDA's
  ``index_add_`` adds in any order).

Arithmetic, as in the dense MLP: the einsums and products take their
operands in the working dtype and accumulate in float32 with one rounding
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` is
off on the card, ``models/model.py``), which is what XLA computes on the
CPU.  Top-k is a stable descending sort, so exact ties go to the lower
expert index as ``jax.lax.top_k``'s do (``torch.topk`` does not promise
an order among ties).  No kernel: the reference's MoE is jnp code that
reaches no Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import F32, gelu, gelu_tanh, silu, swiglu
from repro_torch.models.param import BatchSplit, ParamDef, batch_split, constrain


def capacity(tokens_per_group: int, n_experts: int, top_k: int,
             factor: float = 1.25) -> int:
    """Per-group per-expert buffer size; clamped so tiny decode groups never drop."""
    c = math.ceil(tokens_per_group * top_k / n_experts * factor)
    return max(min(tokens_per_group, max(c, top_k)), 1)


def tokens_per_group(n_tok: int, group: int) -> int:
    """The reference's group: ``min(group, n_tok)`` halved until it divides ``n_tok``."""
    g = min(group, n_tok)
    while n_tok % g:
        g //= 2
    return g


def build_params(d_model: int, n_experts: int, d_ff: int, *, n_shared: int = 0,
                 dtype=torch.bfloat16) -> dict:
    p = {
        "router": ParamDef((d_model, n_experts), ("d_model", None), dtype=torch.float32),
        "w_gate": ParamDef((n_experts, d_model, d_ff), ("experts", "d_model", "expert_ff"),
                           dtype=dtype),
        "w_up": ParamDef((n_experts, d_model, d_ff), ("experts", "d_model", "expert_ff"),
                         dtype=dtype),
        "w_down": ParamDef((n_experts, d_ff, d_model), ("experts", "expert_ff", "d_model"),
                           dtype=dtype),
    }
    if n_shared:
        ff_sh = n_shared * d_ff
        p["shared_gate"] = ParamDef((d_model, ff_sh), ("d_model", "ff"), dtype=dtype)
        p["shared_up"] = ParamDef((d_model, ff_sh), ("d_model", "ff"), dtype=dtype)
        p["shared_down"] = ParamDef((ff_sh, d_model), ("ff", "d_model"), dtype=dtype)
        p["shared_coef"] = ParamDef((d_model, 1), ("d_model", None), dtype=torch.float32)
    return p


def route(router: torch.Tensor, xt: torch.Tensor, *, top_k: int,
          router_weights_renorm: bool = True):
    """The router on grouped tokens ``xt`` (n, g, d): returns ``probs`` (n,
    g, E) f32, the top-k weights ``w`` (n, g, k) f32 and experts ``e_idx``
    (n, g, k) int64, largest first, ties to the lower index."""
    logits = torch.einsum("nsd,de->nse", xt.to(F32), router)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e_idx = vals[..., :top_k], idx[..., :top_k]
    if router_weights_renorm:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return probs, w, e_idx


def aux_loss(probs: torch.Tensor, e_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum(mean prob * share of choices).

    The choices are counted by a ``scatter_add`` of ones (integers, exact
    in f32: the reference's ``bincount`` bits, and it runs on the ``meta``
    device).  Under a ``BatchSplit`` the counts are the global batch's and
    the mean probability is this shard's sum over the global token count,
    so the shards' terms add up to the global loss and its gradient."""
    n_tok, k = probs.shape[0] * probs.shape[1], e_idx.shape[-1]
    flat = e_idx.reshape(-1)
    counts = torch.zeros(n_experts, dtype=F32, device=probs.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=F32, device=probs.device))
    split = batch_split()
    if split is None:
        me = probs.mean(dim=(0, 1))
    else:
        n_tok *= split.count
        me = probs.sum(dim=(0, 1)) / n_tok
        counts = split.sum(counts)
    ce = counts / (n_tok * k)
    return n_experts * torch.sum(me * ce)


def _group_offsets(e_idx: torch.Tensor, n_experts: int, split: BatchSplit, span: int):
    """For one token group spread over ``span`` consecutive batch shards, of
    which this shard holds one part (``e_idx``: (1, part, k)): per choice
    rank and expert, the choices made in the group's earlier parts and in
    the whole group, each (k, E) int64."""
    k = e_idx.shape[-1]
    oh = torch.nn.functional.one_hot(e_idx[0], n_experts)             # (part, k, E)
    every = split.gather(oh.sum(dim=0))                                  # (shards, k, E)
    base = split.index - split.index % span
    return every[base:split.index].sum(dim=0), every[base:base + span].sum(dim=0)


def _experts(p, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU FFN on its capacity buffer (n, E, cap, d)."""
    gate = torch.einsum("necd,edf->necf", buf, p.w_gate)
    up = torch.einsum("necd,edf->necf", buf, p.w_up)
    return torch.einsum("necf,efd->necd", swiglu(gate, up), p.w_down)


def einsum_dispatch(p, xt: torch.Tensor, e_idx: torch.Tensor, w: torch.Tensor, cap: int,
                    n_experts: int, offsets=None) -> torch.Tensor:
    """GShard dispatch: per-choice-rank one-hot (g, E, cap) masks + einsums.

    Position-in-expert is an exclusive cumsum over the group per rank plus
    the counts of earlier ranks; positions at or beyond ``cap`` drop.
    ``offsets`` (:func:`_group_offsets`): ``xt`` is one part of a group
    spread over batch shards, and the group's earlier parts and whole-group
    counts enter the positions.  Returns the combined expert outputs (n, g,
    d) in ``xt``'s dtype."""
    n, g, d = xt.shape
    E, dt = n_experts, xt.dtype
    slots = torch.arange(cap, device=xt.device)
    disp = torch.zeros((n, g, E, cap), dtype=dt, device=xt.device)
    comb = torch.zeros((n, g, E, cap), dtype=dt, device=xt.device)
    counts = torch.zeros((n, 1, E), dtype=torch.int64, device=xt.device)
    for j in range(e_idx.shape[-1]):
        oh_j = torch.nn.functional.one_hot(e_idx[..., j], E)          # (n, g, E)
        pos_j = torch.cumsum(oh_j, dim=1) - oh_j + counts
        if offsets is not None:
            pos_j = pos_j + offsets[0][j]
        keep = (pos_j < cap) & (oh_j > 0)
        d_j = ((pos_j[..., None] == slots) & keep[..., None]).to(dt)  # (n, g, E, cap)
        disp = disp + d_j
        comb = comb + d_j * w[:, :, j, None, None].to(dt)
        counts = counts + (oh_j.sum(dim=1, keepdim=True) if offsets is None else offsets[1][j])
    buf = torch.einsum("ngd,ngec->necd", xt, disp)
    return torch.einsum("ngec,necd->ngd", comb, _experts(p, buf))


def scatter_dispatch(p, xt: torch.Tensor, e_idx: torch.Tensor, w: torch.Tensor, cap: int,
                     n_experts: int, offsets=None) -> torch.Tensor:
    """Positional dispatch: each (token, choice) in token order takes the
    next slot of its expert's buffer (after the choices of the group's
    earlier parts, with ``offsets``); combined outputs (n, g, d)."""
    n, g, d = xt.shape
    k = e_idx.shape[-1]
    flat_e = e_idx.reshape(n, g * k)                                    # token-major
    oh = torch.nn.functional.one_hot(flat_e, n_experts)                 # (n, g*k, E)
    pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1)                 # (n, g*k)
    if offsets is not None:
        pos = pos + (oh * offsets[0].sum(dim=0)).sum(-1)
    keep = pos < cap
    tok = torch.arange(g, device=xt.device).repeat_interleave(k)
    grp = torch.arange(n, device=xt.device)[:, None].expand(n, g * k)
    buf = torch.zeros((n, n_experts, cap, d), dtype=xt.dtype, device=xt.device)
    # kept (group, expert, slot) triples are unique: one add into zeros each
    buf.index_put_((grp[keep], flat_e[keep], pos[keep]), xt[:, tok][keep], accumulate=True)
    out_buf = _experts(p, buf)
    vals = out_buf[grp, flat_e, torch.clamp(pos, max=cap - 1)]         # (n, g*k, d)
    vals = vals * (w.reshape(n, g * k) * keep)[..., None].to(out_buf.dtype)
    vals = vals.reshape(n, g, k, d)
    out = torch.zeros((n, g, d), dtype=out_buf.dtype, device=xt.device)
    for j in range(k):          # the reference's scatter-add order, rounded after each add
        out = out + vals[:, :, j]
    return out


DISPATCHES = {"einsum": einsum_dispatch, "scatter": scatter_dispatch}


def moe_apply(p, x: torch.Tensor, *, n_experts: int, top_k: int, group_size: int = 2048,
              cap_factor: float = 1.25, router_weights_renorm: bool = True,
              dispatch: str = "einsum"):
    """x: (B, T, d) -> (out (B, T, d), aux_loss scalar).  ``p``: the MoE
    module (router, w_gate, w_up, w_down, optionally the shared expert)."""
    B, T, d = x.shape
    n_tok = B * T
    split = batch_split()
    # the group (and so the capacity) follows the global batch's token count
    g = tokens_per_group(n_tok * (split.count if split else 1), group_size)
    cap = capacity(g, n_experts, top_k, cap_factor)
    span = 1
    if g > n_tok and g % n_tok == 0:        # one group over `span` consecutive shards
        span, g = g // n_tok, n_tok
    elif n_tok % g:
        raise ValueError(f"a token group of {g} straddles batch shards of {n_tok} tokens")
    xt = constrain(x.reshape(n_tok // g, g, d), ("moe_groups", None, "d_model"))
    probs, w, e_idx = route(p.router, xt, top_k=top_k,
                            router_weights_renorm=router_weights_renorm)
    offsets = _group_offsets(e_idx, n_experts, split, span) if span > 1 else None
    out = DISPATCHES[dispatch](p, xt, e_idx, w, cap, n_experts, offsets)
    return add_shared(p, x, out.reshape(B, T, d)), aux_loss(probs, e_idx, n_experts)


def add_shared(p, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The always-on shared experts, scaled by a sigmoid gate (f32), added."""
    if not hasattr(p, "shared_gate"):
        return out
    sh = swiglu(x @ p.shared_gate, x @ p.shared_up) @ p.shared_down
    coef = torch.sigmoid(torch.einsum("btd,do->bto", x.to(F32), p.shared_coef))
    return out + sh * coef.to(out.dtype)


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def build_dense_params(d_model: int, d_ff: int, *, act: str = "swiglu",
                       dtype=torch.bfloat16) -> dict:
    if act in ("swiglu", "geglu"):
        return {
            "gate": ParamDef((d_model, d_ff), ("d_model", "ff"), dtype=dtype),
            "up": ParamDef((d_model, d_ff), ("d_model", "ff"), dtype=dtype),
            "down": ParamDef((d_ff, d_model), ("ff", "d_model"), dtype=dtype),
        }
    return {  # plain gelu (whisper)
        "up": ParamDef((d_model, d_ff), ("d_model", "ff"), dtype=dtype),
        "up_b": ParamDef((d_ff,), ("ff",), init="zeros", dtype=dtype),
        "down": ParamDef((d_ff, d_model), ("ff", "d_model"), dtype=dtype),
        "down_b": ParamDef((d_model,), ("d_model",), init="zeros", dtype=dtype),
    }


def dense_apply(p, x: torch.Tensor, *, act: str = "swiglu") -> torch.Tensor:
    """``p``: the MLP module (leaves gate, up, down, or up, up_b, down, down_b).
    The gate is rounded to the working dtype by its product, activated in
    f32 and rounded again before the elementwise product, as in the
    reference."""
    if hasattr(p, "gate"):
        g = (x @ p.gate).to(F32)
        up = x @ p.up
        gated = silu(g) if act == "swiglu" else gelu_tanh(g)
        return (gated.to(up.dtype) * up) @ p.down
    return gelu(x @ p.up + p.up_b) @ p.down + p.down_b
