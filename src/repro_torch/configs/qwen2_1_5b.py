"""qwen2-1.5b [dense] — GQA + QKV bias [arXiv:2407.10671; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936; d_head=128;
QKV projections carry biases; tied embeddings.
"""

from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2_1_5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab=151936,
    period=(LayerSpec(kind="attn"),),
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
)

SMOKE = ArchConfig(
    name="qwen2_1_5b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    period=(LayerSpec(kind="attn"),),
    qkv_bias=True,
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
    moe_group_size=16,
)
