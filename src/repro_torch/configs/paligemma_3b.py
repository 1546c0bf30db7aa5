"""paligemma-3b [vlm] — SigLIP + Gemma backbone [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.  The vision frontend
is a stub per the assignment: ``input_specs`` supplies precomputed patch
embeddings (256 tokens, SigLIP-so400m/14 @ 224px); the backbone applies the
PaliGemma prefix-LM mask (bidirectional over image+prefix, causal after).
d_head=256 (Gemma family), GeGLU MLP, tied embeddings, sqrt(d) embed scale.

The port's copy of ``repro/configs/paligemma_3b.py``: the same fields.
"""

from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="paligemma_3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab=257216,
    period=(LayerSpec(kind="attn"),),
    rope_theta=1e4,
    frontend="vlm",
    n_frontend_tokens=256,
    tie_embeddings=True,
    norm="rmsnorm",
    act="geglu",
    scale_embed=True,
)

SMOKE = ArchConfig(
    name="paligemma_3b_smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab=512,
    period=(LayerSpec(kind="attn"),),
    frontend="vlm",
    n_frontend_tokens=4,
    tie_embeddings=True,
    norm="rmsnorm",
    act="geglu",
    scale_embed=True,
    moe_group_size=16,
)
