"""The dense MLP half of ``repro/models/moe.py``.

SwiGLU, GeGLU and the plain GELU MLP (Whisper's).  The routed
Mixture-of-Experts (``capacity``, ``moe_apply`` and its dispatches) waits
for ``qwen2_moe_a2_7b`` (ROADMAP §1.5).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import F32, gelu, gelu_tanh, silu
from repro_torch.models.param import ParamDef


def build_dense_params(d_model: int, d_ff: int, *, act: str = "swiglu",
                       dtype=torch.bfloat16) -> dict:
    if act in ("swiglu", "geglu"):
        return {
            "gate": ParamDef((d_model, d_ff), ("d_model", "ff"), dtype=dtype),
            "up": ParamDef((d_model, d_ff), ("d_model", "ff"), dtype=dtype),
            "down": ParamDef((d_ff, d_model), ("ff", "d_model"), dtype=dtype),
        }
    return {  # plain gelu (whisper)
        "up": ParamDef((d_model, d_ff), ("d_model", "ff"), dtype=dtype),
        "up_b": ParamDef((d_ff,), ("ff",), init="zeros", dtype=dtype),
        "down": ParamDef((d_ff, d_model), ("ff", "d_model"), dtype=dtype),
        "down_b": ParamDef((d_model,), ("d_model",), init="zeros", dtype=dtype),
    }


def dense_apply(p, x: torch.Tensor, *, act: str = "swiglu") -> torch.Tensor:
    """``p``: the MLP module (leaves gate, up, down, or up, up_b, down, down_b).
    The gate is rounded to the working dtype by its product, activated in
    f32 and rounded again before the elementwise product, as in the
    reference."""
    if hasattr(p, "gate"):
        g = (x @ p.gate).to(F32)
        up = x @ p.up
        gated = silu(g) if act == "swiglu" else gelu_tanh(g)
        return (gated.to(up.dtype) * up) @ p.down
    return gelu(x @ p.up + p.up_b) @ p.down + p.down_b
