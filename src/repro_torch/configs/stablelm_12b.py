"""stablelm-12b [dense] — [hf:stabilityai/stablelm-2-12b].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.  LayerNorm,
SwiGLU, untied head, d_head = 5120/32 = 160.
"""

from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="stablelm_12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=160,
    d_ff=13824,
    vocab=100352,
    period=(LayerSpec(kind="attn"),),
    rope_theta=1e4,
    tie_embeddings=False,
    norm="layernorm",
    act="swiglu",
)

SMOKE = ArchConfig(
    name="stablelm_12b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    period=(LayerSpec(kind="attn"),),
    tie_embeddings=False,
    norm="layernorm",
    act="swiglu",
    moe_group_size=16,
)
