"""Problem configurations (the port's own copies) and the LM architecture
registry.

``get_config(name)`` returns the exact published configuration of an LM
architecture, ``get_smoke(name)`` a CPU-runnable reduction that keeps its
layer pattern (period) and GQA ratio.  The registry holds the dense decoder
family and the routed-MoE decoder (``qwen2_moe_a2_7b``), which this package
serves; the JAX package's other architectures raise ``KeyError`` until
their slice is ported (ROADMAP §1).
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "stablelm_12b",
    "gemma3_12b",
    "qwen2_1_5b",
    "deepseek_7b",
    "qwen2_moe_a2_7b",
]

# CLI-friendly aliases (the assignment sheet's ids)
ALIASES = {
    "stablelm-12b": "stablelm_12b",
    "gemma3-12b": "gemma3_12b",
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-7b": "deepseek_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
}

#: the JAX package's other architectures, by id and alias: later LM slices
NOT_PORTED = {
    "paligemma_3b": "paligemma-3b",
    "rwkv6_7b": "rwkv6-7b",
    "grok_1_314b": "grok-1-314b",
    "whisper_large_v3": "whisper-large-v3",
    "jamba_v0_1_52b": "jamba-v0.1-52b",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name in NOT_PORTED or name in NOT_PORTED.values():
        raise KeyError(f"arch {name!r} is not ported yet; ROADMAP §1 lists the LM "
                       f"slices still to come (ported: {ARCH_IDS})")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
