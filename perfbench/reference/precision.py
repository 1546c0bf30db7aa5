"""Precisions of the reference solvers.

A precision says how a vector or a coefficient field is stored, in which
dtype element-wise work runs, and in which dtype inner products are summed.
``bf16_mixed`` is what the configurations state (the paper's 16-bit storage
with 32-bit reductions).  ``fp8_mixed`` is the control: the same solver with
every stored vector and field in 8-bit floats (e4m3, one power-of-two scale
per tensor), the next precision below; it has to come out as not correct.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

#: elements per chunk of an inner product (its float32 copies stay small)
DOT_CHUNK = 1 << 26


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t


def _fp8_scaled(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under one power-of-two scale, so its largest
    magnitude lands at most at e4m3's largest finite value; the result is
    held in ``t``'s dtype, which every scaled e4m3 value fits exactly."""
    amax = float(t.abs().max())
    if amax == 0.0 or not math.isfinite(amax):
        return t
    scale = 2.0 ** math.ceil(math.log2(amax / torch.finfo(torch.float8_e4m3fn).max))
    return ((t / scale).to(torch.float8_e4m3fn).to(t.dtype)) * scale


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    compute: torch.dtype              # element-wise work and the SpMV
    reduce: torch.dtype               # inner-product sums
    round_store: Callable = _keep     # what storing a compute-dtype tensor does

    def store(self, t: torch.Tensor) -> torch.Tensor:
        return self.round_store(t.to(self.compute))

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``<a, b>``: each product exact in ``reduce`` (16-bit operands),
        summed in ``reduce``, chunk by chunk."""
        a, b = a.reshape(-1), b.reshape(-1)
        total = torch.zeros((), dtype=self.reduce, device=a.device)
        for i in range(0, a.numel(), DOT_CHUNK):
            total += torch.dot(a[i:i + DOT_CHUNK].to(self.reduce),
                               b[i:i + DOT_CHUNK].to(self.reduce))
        return total


PRECISIONS = {
    "bf16_mixed": Precision("bf16_mixed", torch.bfloat16, torch.float32),
    "fp8_mixed": Precision("fp8_mixed", torch.bfloat16, torch.float32, _fp8_scaled),
    "f32": Precision("f32", torch.float32, torch.float32),
}

#: the precision a control runs in, for each precision a configuration states
CONTROL_OF = {"bf16_mixed": "fp8_mixed"}
