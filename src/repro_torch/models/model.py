"""Model-level serving API: prefill_step and serve_step (decode).

The port of ``repro/models/model.py``'s serving half.  ``make_prefill_step``
and ``make_serve_step`` keep the reference's names and signatures,
``step(params, batch, caches) -> (logits, caches)``, where ``params`` is a
:class:`repro_torch.models.transformer.DecoderLM` and ``caches`` the list
``init_caches`` returns; the steps write the caches in place and return
them.  Training (``loss_fn``, ``make_train_step``) and the abstract/sharding
helpers of the dry-run are not ported yet (ROADMAP §1, items 3.4 and 3.5).

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
from repro_torch.models.param import ParamDef, count_params, init_tree, map_tree, tree_leaves
from repro_torch.models.transformer import ArchConfig, DecoderLM


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

def init_params(cfg: ArchConfig, gen: torch.Generator,
                device: str | torch.device | None = "cuda") -> DecoderLM:
    """Random weights drawn on ``gen`` (on its device), placed on ``device``
    (the card unless the caller names the CPU)."""
    dev = resolve_device(device)
    return DecoderLM.from_tree(cfg, init_tree(transformer.build_model_defs(cfg), gen, dev))


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
