"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) per-expert d_ff=1408 vocab=151936; every layer
is MoE with 4 always-on shared experts (total shared ff = 5632) gated by a
sigmoid coefficient; QKV bias (Qwen family); d_head=128.
60 experts do not divide the 16-way model axis, so expert weights shard
tensor-parallel on the expert-ff dimension (DESIGN.md §6).

The port's copy of ``repro/configs/qwen2_moe_a2_7b.py``: the same fields.
"""

from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2_moe_a2_7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=5632,             # shared-expert aggregate (4 x 1408)
    vocab=151936,
    period=(LayerSpec(kind="attn", moe=True),),
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_ff_expert=1408,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=False,
    norm="rmsnorm",
    act="swiglu",
)

SMOKE = ArchConfig(
    name="qwen2_moe_a2_7b_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=64,
    vocab=512,
    period=(LayerSpec(kind="attn", moe=True),),
    n_experts=8,
    top_k=4,
    n_shared_experts=2,
    d_ff_expert=32,
    qkv_bias=True,
    tie_embeddings=False,
    norm="rmsnorm",
    act="swiglu",
    moe_group_size=16,
)
