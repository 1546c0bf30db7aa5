"""gemma3-12b [dense] — 5:1 local:global interleave [hf:google/gemma-3-12b-pt].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.  Five sliding-window
(1024) layers per global layer; d_head=256; GeGLU; tied embeddings with
sqrt(d) scaling.  The sliding-window layers are a 1-D sequence stencil and
use the halo-style masking path (DESIGN.md §6); the 1-in-6 global layers
keep the arch quadratic => long_500k is skipped per the assignment rule.
"""

from repro_torch.models.transformer import ArchConfig, LayerSpec

_PERIOD = tuple(
    [LayerSpec(kind="attn", window=1024)] * 5 + [LayerSpec(kind="attn")]
)

CONFIG = ArchConfig(
    name="gemma3_12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab=262144,
    period=_PERIOD,
    rope_theta=1e6,
    tie_embeddings=True,
    norm="rmsnorm",
    act="geglu",
    scale_embed=True,
)

SMOKE = ArchConfig(
    name="gemma3_12b_smoke",
    family="dense",
    n_layers=6,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    period=tuple([LayerSpec(kind="attn", window=8)] * 5 + [LayerSpec(kind="attn")]),
    tie_embeddings=True,
    norm="rmsnorm",
    act="geglu",
    scale_embed=True,
    moe_group_size=16,
)
