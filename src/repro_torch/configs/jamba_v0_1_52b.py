"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7, MoE 16e top-2
[arXiv:2403.19887; hf:ai21labs/Jamba-v0.1].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  Period of 8 layers:
attention at position 4, Mamba elsewhere; MoE (16 experts, top-2, per-expert
ff=14336) on odd positions (every other layer).  Fully sub-quadratic in its
Mamba layers; the sparse attention layers make long_500k run with the
sequence-sharded flash-decode path (the paper's partial-reduction AllReduce).
16 experts divide the model axis => true expert parallelism.

The port's copy of ``repro/configs/jamba_v0_1_52b.py``: the same fields.
"""

from repro_torch.models.transformer import ArchConfig, LayerSpec

_PERIOD = tuple(
    LayerSpec(kind="attn" if i == 4 else "mamba", moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba_v0_1_52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=65536,
    period=_PERIOD,
    n_experts=16,
    top_k=2,
    d_ff_expert=14336,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=1e4,
    tie_embeddings=False,
    norm="rmsnorm",
    act="swiglu",
    # 104 GB bf16 weights: FSDP-style spread over data axes (6.5 -> 0.4
    # GB/chip) — also what makes long_500k decode 15.6x faster (§Perf).
    rules=(
        ("expert_ff", ("model", "data")),
        ("ff", ("model", "data")),
        ("heads_flat", ("model", "data")),
        ("kv_seq", ("model", "data")),
    ),
)

SMOKE = ArchConfig(
    name="jamba_v0_1_52b_smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    period=tuple(
        LayerSpec(kind="attn" if i == 4 else "mamba", moe=(i % 2 == 1))
        for i in range(8)
    ),
    n_experts=4,
    top_k=2,
    d_ff_expert=32,
    mamba_d_state=4,
    mamba_d_conv=4,
    mamba_expand=2,
    tie_embeddings=False,
    norm="rmsnorm",
    act="swiglu",
    moe_group_size=16,
)
