"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) per-expert d_ff=32768 vocab=131072;
d_head=128; attention-logit softcap 30; GeGLU experts; every layer MoE.
The largest assigned cell (~314B params): expert weights are TP-sharded on
the ff dimension (8 experts < 16-way model axis), params+optimizer live
sharded (~1.2 GB/chip bf16 on 512 chips).

The port's copy of ``repro/configs/grok_1_314b.py``: the same fields.  At
full width it is structure only here (defs and counts): 633 GB of bf16
weights fit on no one card.
"""

from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="grok_1_314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,
    vocab=131072,
    period=(LayerSpec(kind="attn", moe=True),),
    n_experts=8,
    top_k=2,
    d_ff_expert=32768,
    attn_softcap=30.0,
    rope_theta=1e4,
    tie_embeddings=False,
    norm="rmsnorm",
    act="geglu",
    scale_embed=True,
    # FSDP-style: 633 GB of bf16 weights (316.5 B parameters) cannot live 16-way sharded
    # (39 GB/chip); spread the big dims over the data axes too.  GSPMD
    # all-gathers weights per layer — the standard 300B-class trade.
    rules=(
        ("expert_ff", ("model", "data")),
        ("ff", ("model", "data")),
        ("vocab", ("model", "data")),
        ("heads", ("model", "data")),
        # dispatch/combine buffers are the next footprint driver at 6144-d:
        # spread MoE token groups over the model axis too (weights are
        # FSDP-gathered per layer regardless)
        ("moe_groups", ("pod", "data", "model")),
    ),
)

SMOKE = ArchConfig(
    name="grok_1_314b_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    period=(LayerSpec(kind="attn", moe=True),),
    n_experts=8,
    top_k=2,
    d_ff_expert=64,
    attn_softcap=30.0,
    tie_embeddings=False,
    norm="rmsnorm",
    act="geglu",
    scale_embed=True,
    moe_group_size=16,
)
