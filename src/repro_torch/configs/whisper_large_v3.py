"""whisper-large-v3 [audio] — encoder-decoder [arXiv:2212.04356].

32+32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.  The conv frontend is
a STUB per the assignment: ``input_specs`` provides precomputed frame
embeddings to the encoder.  Decoder layers: causal self-attention +
cross-attention to the (frozen at decode: 1500 frames) encoder output.
LayerNorm + plain GELU MLP; RoPE substitutes the original learned/sinusoidal
positions (documented deviation, DESIGN.md §11).  20 heads do not divide the
16-way model axis => head projections fall back to d_head sharding.

The port's copy of ``repro/configs/whisper_large_v3.py``: the same fields.
"""

from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper_large_v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_head=64,
    d_ff=5120,
    vocab=51866,
    period=(LayerSpec(kind="attn", cross=True),),
    enc_dec=True,
    n_enc_layers=32,
    frontend="audio",
    enc_len_decode=1500,
    rope_theta=1e4,
    tie_embeddings=True,
    norm="layernorm",
    act="gelu",
)

SMOKE = ArchConfig(
    name="whisper_large_v3_smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=512,
    period=(LayerSpec(kind="attn", cross=True),),
    enc_dec=True,
    n_enc_layers=2,
    frontend="audio",
    enc_len_decode=8,
    tie_embeddings=True,
    norm="layernorm",
    act="gelu",
    moe_group_size=16,
)
