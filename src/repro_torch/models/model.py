"""Model-level API: train_step, prefill_step and serve_step (decode).

The port of ``repro/models/model.py``'s steps.  Serving:
``make_prefill_step`` and ``make_serve_step`` keep the reference's names and
signatures, ``step(params, batch, caches) -> (logits, caches)``, where
``params`` is a :class:`repro_torch.models.transformer.DecoderLM` and
``caches`` the list ``init_caches`` returns; the steps write the caches in
place and return them, under ``torch.inference_mode``.

Training: ``loss_fn`` (the chunked-over-sequence cross-entropy plus the MoE
auxiliary loss) and ``make_train_step(cfg, lr_peak, total_steps)``, whose
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
takes the stacked parameter tree (``init_train_params``, or the JAX
package's tree through ``param.tree_from_numpy``) and an
``optim.AdamWState``.  The gradients are autograd's, as the reference's are
``jax.value_and_grad``'s; the step returns new trees and leaves its inputs
as they were.  The same step across the ranks of a mesh, with the
parameters and the ZeRO-1 moments split by the specs here, is
``runtime/sharded.py``.

Abstract stand-ins (for the dry-run, ``launch/dryrun.py``): ``input_specs``,
``abstract_params``, ``abstract_caches`` and ``abstract_opt_state`` give
meta tensors of the reference's shapes and dtypes, each carrying its
``param.Spec`` on a ``RankMesh`` as ``.spec``; ``param_shardings`` and
``out_shardings_for_train`` give the Spec trees; ``probe_config`` the
1- and 2-period cost probes.

Matrix-product settings on the card, set by the steps: TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``), so float32 products
(the attention scores and ``p @ v``) run in full float32 as the reference's
``preferred_element_type=jnp.float32`` products do; and
``allow_bf16_reduced_precision_reduction = False``, so cuBLAS never reduces
a split-K bfloat16 product in bfloat16: every bfloat16 product accumulates
in float32 and rounds once, as XLA's does.  Both are process-wide flags.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, transformer
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models.param import (
    ParamDef, Spec, abstract_tree, batch_split, count_params, init_tree, map_tree, physical_spec,
    sharding_tree, tree_leaves, zero1_sharding_tree, zero1_spec,
)
from repro_torch.models.transformer import ArchConfig, DecoderLM
from repro_torch.optim.adamw import AdamWState, adamw_update, cosine_lr


# ---------------------------------------------------------------------------
# Shapes (the assigned benchmark cells)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
    # reduced shapes for CPU smoke tests
    "smoke_train": ShapeSpec("smoke_train", 32, 2, "train"),
    "smoke_prefill": ShapeSpec("smoke_prefill", 32, 2, "prefill"),
    "smoke_decode": ShapeSpec("smoke_decode", 32, 2, "decode"),
}


def cell_is_supported(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """The (arch x shape) gate: long_500k runs only for SSM/hybrid or
    sub-quadratic families; pure full-attention archs skip it."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid") or cfg.sub_quadratic:
            return True, ""
        return False, (
            "long_500k requires sub-quadratic token mixing; "
            f"{cfg.name} ({cfg.family}) is full-attention (skip per spec, DESIGN.md §6)"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors carrying their specs)
# ---------------------------------------------------------------------------

def _meta(shape, dtype, spec: Spec | None) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device="meta")
    if spec is not None:
        t.spec = spec
    return t


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mesh=None) -> dict:
    """Meta stand-ins for every model input of this cell (the reference's
    shapes and dtypes: token ids int32)."""
    B, T = shape.global_batch, shape.seq_len

    def sds(shp, dtype, axes):
        return _meta(shp, dtype, physical_spec(shp, axes, mesh) if mesh is not None else None)

    batch: dict = {}
    if shape.kind in ("train", "prefill"):
        t_text = T - (cfg.n_frontend_tokens if cfg.frontend == "vlm" else 0)
        batch["tokens"] = sds((B, t_text), torch.int32, ("batch", "seq"))
        if shape.kind == "train":
            batch["labels"] = sds((B, t_text), torch.int32, ("batch", "seq"))
            batch["loss_mask"] = sds((B, t_text), torch.float32, ("batch", "seq"))
        if cfg.frontend == "vlm":
            batch["patch_embeds"] = sds((B, cfg.n_frontend_tokens, cfg.d_model),
                                        cfg.dtype, ("batch", "seq", "d_model"))
        if cfg.enc_dec:
            enc_len = T if shape.kind == "train" else min(T, 4 * cfg.enc_len_decode)
            batch["frames"] = sds((B, enc_len, cfg.d_model), cfg.dtype,
                                  ("batch", "seq", "d_model"))
    else:  # decode
        batch["token"] = sds((B, 1), torch.int32, ("batch", None))
    return batch


def abstract_params(cfg: ArchConfig, mesh=None) -> dict:
    return abstract_tree(transformer.build_model_defs(cfg), mesh)


def abstract_caches(cfg: ArchConfig, shape: ShapeSpec, mesh=None) -> dict:
    return abstract_tree(transformer.build_cache_defs(cfg, shape.global_batch,
                                                      shape.seq_len), mesh)


def param_shardings(cfg: ArchConfig, mesh) -> dict:
    return sharding_tree(transformer.build_model_defs(cfg), mesh)


def n_params(cfg: ArchConfig) -> int:
    return count_params(transformer.build_model_defs(cfg))


def n_active_params(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: routed experts counted at top_k/E)."""
    total = 0
    for path, leaf in tree_leaves(transformer.build_model_defs(cfg)):
        size = math.prod(leaf.shape)
        if "moe" in path and any(s in path for s in ("w_gate", "w_up", "w_down")):
            size = size * cfg.top_k // max(cfg.n_experts, 1)
        total += size
    return total


# ---------------------------------------------------------------------------
# Real initialization
# ---------------------------------------------------------------------------

def init_train_params(cfg: ArchConfig, gen: torch.Generator,
                      device: str | torch.device | None = "cuda") -> dict:
    """Random weights drawn on ``gen`` (on its device), placed on ``device``
    (the card unless the caller names the CPU), as the stacked parameter
    tree of ``build_model_defs`` (the reference's layout, leaf for leaf):
    the trainable state."""
    dev = resolve_device(device)
    return init_tree(transformer.build_model_defs(cfg), gen, dev)


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device: str | torch.device | None = "cuda") -> DecoderLM:
    """:func:`init_train_params`'s weights as the serving model (views of
    the stacked tensors: nothing is copied)."""
    return DecoderLM.from_tree(cfg, init_train_params(cfg, gen, device))


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device: str | torch.device | None = "cuda") -> list[dict]:
    """Zeroed caches on ``device``: one per layer in layer order, each one
    period slice of ``transformer.build_cache_defs`` (an attention cache's
    length a Python int): ``{"attn"}`` (+ ``cross_k``/``cross_v`` of
    ``enc_len_decode`` frames, which prefill replaces), ``{"ssm", "conv"}``
    or ``{"wkv", "tm_shift", "cm_shift"}``."""
    dev = resolve_device(device)
    enc_len = cfg.enc_len_decode if cfg.enc_dec else 0

    def zeros(d: ParamDef):
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)

    out = []
    for spec in cfg.layer_specs():
        c = transformer._layer_cache_defs(cfg, spec, batch, max_len, enc_len)
        attn = c.pop("attn", None)
        c = map_tree(zeros, c)
        if attn is not None:
            c["attn"] = attention.init_cache(batch, max_len, cfg.n_kv_heads, cfg.d_head,
                                             dtype=cfg.dtype, device=dev)
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _matmul_flags(device: torch.device) -> None:
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            aux_weight: float = 0.01, loss_chunks: int = 8):
    """Chunked-over-sequence loss: the (tokens x vocab) logits of one chunk
    at a time, a Python loop over ``loss_chunks`` (or the largest divisor of
    the text length below it).  Returns (total, (loss, aux)).  ``params``:
    the stacked tree; the VLM's patch positions are dropped from the hidden
    states before the head.

    Under a ``param.BatchSplit`` (the sharded step) ``batch`` is one shard
    of the global batch, and the loss and the MoE's auxiliary loss are this
    shard's terms of the global ones: the numerator over this shard's
    tokens, divided by the global mask count, so that their sums over the
    shards (values and gradients) are the one-rank step's of the global
    batch."""
    view = transformer.model_view(cfg, params)
    hidden, _, aux = transformer.forward(cfg, view, batch, mode="train", return_logits=False)
    if cfg.frontend == "vlm":
        hidden = hidden[:, batch["patch_embeds"].shape[1]:]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(batch["labels"].shape, dtype=torch.float32, device=hidden.device)

    T = hidden.shape[1]
    n = loss_chunks
    while T % n:
        n -= 1
    csz = T // n
    num = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * csz, (i + 1) * csz)
        logits_c = transformer.apply_head(cfg, view, hidden[:, sl])
        num = num + cross_entropy_loss(logits_c, batch["labels"][:, sl], mask[:, sl]) \
            * torch.clamp(mask[:, sl].sum(), min=1.0)
    den = mask.sum()
    split = batch_split()
    if split is not None:       # the global batch's token count; num stays this shard's
        den = split.sum(den)
    loss = num / torch.clamp(den, min=1.0)
    return loss + aux_weight * aux, (loss, aux)


def make_train_step(cfg: ArchConfig, *, lr_peak: float = 3e-4, total_steps: int = 10000):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params``: the stacked tree; ``batch``: tensors on its device.  The
    metrics are the reference's, as tensors: ``loss``, ``aux_loss``,
    ``total_loss``, ``lr`` and ``grad_step``.  A leaf no gradient reaches
    gets a zero gradient, as under ``jax.value_and_grad``."""

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        leaves = tree_leaves(params)
        _matmul_flags(leaves[0][1].device)
        live = {path: t.detach().requires_grad_() for path, t in leaves}
        p = map_tree(lambda path, _: live[path], params, with_path=True)
        with torch.enable_grad():
            total, (loss, aux) = loss_fn(cfg, p, batch)
            grads = torch.autograd.grad(total, list(live.values()), allow_unused=True)
        got = {path: torch.zeros_like(t) if g is None else g
               for (path, t), g in zip(live.items(), grads)}
        grads = map_tree(lambda path, _: got[path], params, with_path=True)
        lr = cosine_lr(opt_state.count, peak=lr_peak, total=total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        metrics = {"loss": loss.detach(), "aux_loss": aux.detach(),
                   "total_loss": total.detach(), "lr": lr, "grad_step": opt_state.count}
        return params, opt_state, metrics

    return train_step


def probe_config(cfg: ArchConfig, k_periods: int, seq_len: int | None = None) -> ArchConfig:
    """Cost-probe twin: k periods, the reference's probe fields
    (``unroll``, ``inner_unroll``, no remat, the flash block coarsened to
    ``seq/4``).  The dry-run traces the 1- and 2-period twins, whose
    difference is the exact per-period cost, and extrapolates to the full
    depth."""
    T = seq_len or (1 << 15)
    return dataclasses.replace(
        cfg,
        name=f"{cfg.name}_probe{k_periods}",
        n_layers=k_periods * len(cfg.period),
        n_enc_layers=k_periods if cfg.enc_dec else 0,
        unroll=True,
        remat=False,
        attn_block=max(1024, T // 4),
        inner_unroll=True,
    )


def abstract_opt_state(cfg: ArchConfig, mesh=None) -> AdamWState:
    """Optimizer moments: f32 meta tensors of the parameters' shapes,
    carrying ZeRO-1 specs (the parameter's spec + the batch axes over the
    largest free dimension); ``count`` an int32 scalar."""
    def mk(d: ParamDef):
        return _meta(d.shape, torch.float32,
                     zero1_spec(d.shape, d.axes, mesh) if mesh is not None else None)

    defs = transformer.build_model_defs(cfg)
    return AdamWState(mu=map_tree(mk, defs), nu=map_tree(mk, defs),
                      count=_meta((), torch.int32, None))


def out_shardings_for_train(cfg: ArchConfig, mesh):
    """(params, opt_state, metrics) specs: parameters keep their layout,
    the moments ZeRO-1, ``count`` and the metrics replicated."""
    defs = transformer.build_model_defs(cfg)
    z1 = zero1_sharding_tree(defs, mesh)
    opt = AdamWState(mu=z1, nu=map_tree(lambda s: s, z1), count=Spec())
    metrics = {k: Spec() for k in ("loss", "aux_loss", "total_loss", "lr", "grad_step")}
    return param_shardings(cfg, mesh), opt, metrics


def make_prefill_step(cfg: ArchConfig, shape: ShapeSpec):
    def prefill_step(params: DecoderLM, batch: dict, caches: list):
        _matmul_flags(params.embed.device)
        with torch.inference_mode():
            hidden, caches, _ = transformer.forward(cfg, params, batch, mode="prefill",
                                                    caches=caches, return_logits=False)
            # vocab projection for the LAST position only (the one serving needs)
            logits = transformer.apply_head(cfg, params, hidden[:, -1:])
        return logits, caches

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """One decode step: next-token logits + updated caches."""

    def serve_step(params: DecoderLM, batch: dict, caches: list):
        _matmul_flags(params.embed.device)
        with torch.inference_mode():
            logits, caches, _ = transformer.forward(cfg, params, batch, mode="decode",
                                                    caches=caches)
        return logits, caches

    return serve_step
