"""int8 gradient compression with error feedback (for the data-parallel
reduction).

The port of ``repro/optim/compress.py``.  Each leaf is quantized to int8
with one f32 scale per leaf (per stacked leaf, in the reference's layout)
before the cross-replica reduction; the quantization error is carried to
the next step (error feedback), so convergence is preserved.  It cuts the
gradient traffic 4x against f32, 2x against bf16.  ``torch.round`` rounds
half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

from repro_torch.models.param import map_tree, map_trees
from repro_torch.optim.adamw import div

F32 = torch.float32


def _quantize(g: torch.Tensor, e: torch.Tensor):
    gf = g.to(F32) + e
    scale = div(torch.clamp(torch.max(torch.abs(gf)), min=1e-12), 127.0)
    qi = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_e = gf - qi.to(F32) * scale
    return qi, scale, new_e


@torch.no_grad()
def compress_grads(grads, error):
    """Returns (int8_tree, scales_tree, new_error_tree); ``error`` None
    starts from zero error."""
    if error is None:
        error = map_tree(lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), grads)
    out = map_trees(_quantize, grads, error)
    pick = lambda i: map_trees(lambda _, r: r[i], grads, out)
    return pick(0), pick(1), pick(2)


@torch.no_grad()
def decompress_grads(qs, scales):
    return map_trees(lambda q, s: q.to(F32) * s, qs, scales)
