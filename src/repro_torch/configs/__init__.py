"""Problem configurations (the port's own copies) and the LM architecture
registry.

``get_config(name)`` returns the exact published configuration of an LM
architecture, ``get_smoke(name)`` a CPU-runnable reduction that keeps its
layer pattern (period), GQA ratio, MoE routing and frontend stubs.  The
registry holds the JAX package's ten architectures, in its order.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "paligemma_3b",
    "stablelm_12b",
    "gemma3_12b",
    "qwen2_1_5b",
    "deepseek_7b",
    "rwkv6_7b",
    "qwen2_moe_a2_7b",
    "grok_1_314b",
    "whisper_large_v3",
    "jamba_v0_1_52b",
]

# CLI-friendly aliases (the assignment sheet's ids)
ALIASES = {
    "paligemma-3b": "paligemma_3b",
    "stablelm-12b": "stablelm_12b",
    "gemma3-12b": "gemma3_12b",
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-7b": "deepseek_7b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "grok-1-314b": "grok_1_314b",
    "whisper-large-v3": "whisper_large_v3",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
