"""Analytic memory model per (arch x shape x mesh) cell: the port of
``repro/launch/roofline_model.py``, the same formulas.

The dry-run (``launch/dryrun.py``) counts the bytes of every aten op of a
traced step, each operand and result once: the unfused count, since the
port runs unfused eager kernels (every intermediate, attention scores and
softmax temporaries among them, goes through HBM).  This module computes
the idealised fused-executor traffic beside it — weights, boundary
activations, KV-cache, MoE buffers, logits — from first principles, and a
static footprint (parameters + optimizer + cache + remat working set)
against one card's memory.  Every ``est_*`` byte count equals the
reference's on the same mesh; the only device number is the card's memory,
``HBM_PER_CARD``: the H100 SXM's 80 GB of HBM3 (NVIDIA H100 Tensor Core GPU
data sheet), where the reference holds a 16 GiB chip (``est_fits_16gb``
there, ``est_fits_hbm`` and ``hbm_bytes`` here).
"""

from __future__ import annotations

import math

from repro_torch.models.model import ShapeSpec
from repro_torch.models.param import _mesh_axis_sizes, physical_spec, tree_leaves
from repro_torch.models.transformer import ArchConfig, build_model_defs

#: one H100 SXM's memory: 80 GB of HBM3 (NVIDIA data sheet)
HBM_PER_CARD = 80 * 10 ** 9


def _shard_product(shape, axes, mesh) -> int:
    """Total shard count physical_spec assigns to this array."""
    sizes = _mesh_axis_sizes(mesh)
    spec = physical_spec(tuple(shape), tuple(axes), mesh)
    prod = 1
    for entry in spec:
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            prod *= sizes[ax]
    return prod


def _params_bytes_per_chip(cfg: ArchConfig, mesh) -> float:
    defs = build_model_defs(cfg)
    total = 0.0
    for _, d in tree_leaves(defs):
        n = math.prod(d.shape)
        total += n * d.dtype.itemsize / _shard_product(d.shape, d.axes, mesh)
    return total


def lm_cell_memory_estimate(cfg: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    sizes = _mesh_axis_sizes(mesh)
    n_dev = math.prod(sizes.values())
    d_batch = _shard_product((shape.global_batch,), ("batch",), mesh)
    d_model_ax = sizes.get("model", 1)
    B, T = shape.global_batch, shape.seq_len
    itemsize = 2  # bf16 storage

    p_bytes = _params_bytes_per_chip(cfg, mesh)
    kind = shape.kind
    tok = B * (T if kind != "decode" else 1) / d_batch

    # ---- per-layer boundary-activation traffic (fused executor) ----
    d = cfg.d_model
    act = 0.0
    cache_bytes = 0.0
    for spec in cfg.period:
        count = cfg.n_periods
        if spec.kind == "attn":
            ctx = T if kind != "decode" else T     # decode reads full cache
            # residual stream + norms: ~6 passes fwd
            layer = 6 * tok * d * itemsize
            # q/k/v/o boundary tensors
            h_shard = _shard_product((d, cfg.n_heads, cfg.d_head),
                                     ("d_model", "heads", "head_dim"), mesh)
            layer += 6 * tok * cfg.n_heads * cfg.d_head * itemsize / max(h_shard // 1, 1)
            if kind == "decode":
                # read the whole (sharded) KV cache once per step
                kv = B / d_batch * ctx * cfg.n_kv_heads * cfg.d_head * 2 * itemsize
                kv /= _shard_product((B, ctx, cfg.n_kv_heads, cfg.d_head),
                                     ("batch", "kv_seq", "kv_heads", "head_dim"),
                                     mesh) / d_batch
                layer += kv
                cache_bytes += kv
            else:
                # flash: K/V stream once per query chunk; assume 2 passes
                layer += 2 * tok * cfg.n_kv_heads * cfg.d_head * 2 * itemsize
        elif spec.kind == "mamba":
            d_in = cfg.mamba_expand * d
            din_shard = _shard_product((d, d_in), ("d_model", "heads_flat"), mesh)
            layer = 8 * tok * d * itemsize + 6 * tok * d_in * itemsize / max(din_shard, 1)
            # chunked scan states spill once per chunk (chunk=256)
            layer += tok * d_in * cfg.mamba_d_state * 4 / max(din_shard, 1) / 256 * 2
        elif spec.kind == "rwkv":
            layer = 10 * tok * d * itemsize
            layer += 2 * tok * cfg.d_ff * itemsize / d_model_ax
        else:
            layer = 0.0
        if spec.kind != "rwkv":
            if spec.moe:
                cap_f = 1.25
                ff = cfg.d_ff_expert
                # MoE groups may shard beyond the batch axes ("moe_groups")
                g_extra = _shard_product((1 << 20,), ("moe_groups",), mesh) \
                    / max(d_batch, 1)
                layer += 2 * tok * cfg.top_k * cap_f * d * itemsize / max(g_extra, 1)
                layer += 2 * tok * cfg.top_k * cap_f * ff * itemsize / d_model_ax
                if cfg.n_shared_experts:
                    layer += 3 * tok * cfg.n_shared_experts * cfg.d_ff_expert \
                        * itemsize / d_model_ax
            else:
                layer += 3 * tok * cfg.d_ff * itemsize / d_model_ax
        act += layer * count

    # logits + loss (train: chunked over sequence, 8 chunks — model.loss_fn;
    # prefill: last position only)
    v_shard = _shard_product((cfg.vocab, d), ("vocab", "d_model"), mesh)
    logit_tok = tok if kind == "train" else B / d_batch
    logits = logit_tok * cfg.vocab * itemsize / max(v_shard, 1) * (3 if kind == "train" else 1)
    logit_chunks = 8 if kind == "train" else 1

    if kind == "train":
        # fwd + remat-fwd + bwd activation passes; params w/grad/opt traffic
        traffic = p_bytes * (2 + 1) + p_bytes / itemsize * (4 + 4 + 16 + 2) \
            + 3 * act + logits
    elif kind == "prefill":
        traffic = p_bytes + act + logits + cache_bytes
    else:
        traffic = p_bytes + act + logits
    # ---- static footprint (the "fits" proof) ----
    # ZeRO-1: moments (f32, 8B/param) and grads shard over the batch axes too
    zero_shard = max(d_batch, 1)
    opt = p_bytes / itemsize * 8 / zero_shard if kind == "train" else 0.0
    grads = p_bytes * 2 / zero_shard if kind == "train" else 0.0
    cache_static = 0.0
    if kind != "train":
        for spec in cfg.period:
            if spec.kind == "attn":
                sh = _shard_product((B, T, cfg.n_kv_heads, cfg.d_head),
                                    ("batch", "kv_seq", "kv_heads", "head_dim"), mesh)
                cache_static += cfg.n_periods * 2 * B * T * cfg.n_kv_heads \
                    * cfg.d_head * itemsize / sh
            elif spec.kind == "mamba":
                d_in = cfg.mamba_expand * d
                cache_static += cfg.n_periods * B / d_batch * d_in \
                    * (cfg.mamba_d_state * 4 + cfg.mamba_d_conv * 2) / d_model_ax
            elif spec.kind == "rwkv":
                H = d // cfg.rwkv_head_size
                cache_static += cfg.n_periods * B / d_batch \
                    * (H * cfg.rwkv_head_size ** 2 * 4 / d_model_ax + 2 * d * 2)
    # the remat stash and residual stream are sequence-sharded at layer
    # boundaries (Megatron-SP, "seq_act" rule) in full-sequence modes
    seq_shard = _shard_product((B, T, d), ("batch", "seq_act", "d_model"), mesh) \
        / max(d_batch, 1) if kind != "decode" else 1
    remat_stash = (cfg.n_layers * tok * d * itemsize / max(seq_shard, 1)) \
        if kind == "train" else 0.0
    # peak live set ~ 2x one layer's boundary traffic (XLA reuses sequential
    # temps) + the chunked logits buffers
    peak_work = act / max(cfg.n_layers, 1) * 2 + logit_tok * cfg.vocab \
        * itemsize / max(v_shard, 1) * 3 / logit_chunks
    footprint = p_bytes + opt + grads + cache_static + remat_stash + peak_work

    return {
        "est_hbm_traffic_bytes": traffic,
        "est_params_bytes": p_bytes,
        "est_cache_bytes": cache_static,
        "est_footprint_bytes": footprint,
        "est_fits_hbm": bool(footprint < HBM_PER_CARD),
        "hbm_bytes": HBM_PER_CARD,
        "est_footprint_gb": footprint / 2 ** 30,
    }


def stencil_cell_memory_estimate(mesh_shape, n_dev_xy: tuple[int, int, int],
                                 itemsize: int = 2) -> dict:
    """BiCGStab iteration traffic: paper §IV — 10 state vectors/core; per
    iteration 2 fused SpMV sweeps (read 6 coeffs + v, write u) + 6 AXPY
    sweeps + 4 dot reads.  words/pt: spmv 2x(8) + axpy 6x3 + dots 8 = 42."""
    X, Y, Z = mesh_shape
    px, py, pz = n_dev_xy
    pts = X * Y * Z / (px * py * pz)
    words = 2 * 8 + 6 * 3 + 8
    traffic = pts * words * itemsize
    footprint = pts * 10 * itemsize
    return {
        "est_hbm_traffic_bytes": traffic,
        "est_footprint_bytes": footprint,
        "est_fits_hbm": bool(footprint < HBM_PER_CARD),
        "hbm_bytes": HBM_PER_CARD,
        "est_footprint_gb": footprint / 2 ** 30,
    }
