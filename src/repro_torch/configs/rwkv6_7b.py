"""rwkv6-7b "Finch" [ssm] — data-dependent decay, attention-free
[arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b].

32L d_model=4096 d_ff=14336 vocab=65536; head_size 64 (64 heads).  Fully
sub-quadratic: long_500k runs (O(1) state per layer).  LayerNorm per the
RWKV family.

The port's copy of ``repro/configs/rwkv6_7b.py``: the same fields.
"""

from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="rwkv6_7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # d_model / head_size
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab=65536,
    period=(LayerSpec(kind="rwkv"),),
    rwkv_head_size=64,
    tie_embeddings=False,
    norm="layernorm",
    act="swiglu",          # unused (channel-mix has its own FFN)
)

SMOKE = ArchConfig(
    name="rwkv6_7b_smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=512,
    period=(LayerSpec(kind="rwkv"),),
    rwkv_head_size=16,
    tie_embeddings=False,
    norm="layernorm",
    act="swiglu",
    moe_group_size=16,
)
