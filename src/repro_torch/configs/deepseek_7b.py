"""deepseek-7b [dense] — llama-arch MHA [arXiv:2401.02954; hf].

30L d_model=4096 32H (kv=32, i.e. full MHA) d_ff=11008 vocab=102400;
d_head=128; untied head; SwiGLU; RMSNorm.
"""

from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="deepseek_7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    vocab=102400,
    period=(LayerSpec(kind="attn"),),
    rope_theta=1e4,
    tie_embeddings=False,
    norm="rmsnorm",
    act="swiglu",
)

SMOKE = ArchConfig(
    name="deepseek_7b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=512,
    period=(LayerSpec(kind="attn"),),
    tie_embeddings=False,
    norm="rmsnorm",
    act="swiglu",
    moe_group_size=16,
)
