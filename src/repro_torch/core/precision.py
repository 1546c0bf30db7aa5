"""Floating-point precision policies (paper §IV-3, §VI-B, Table I).

Counterpart of ``repro/core/precision.py`` with torch dtypes:

* ``storage``  — dtype of the solver state (x, r, p, q, s, y, coeffs)
* ``compute``  — dtype of elementwise work (stencil products, AXPYs)
* ``reduce``   — dtype of inner-product accumulation

Every elementwise op rounds to its dtype as written (torch eager semantics);
the JAX package's strict-precision mode (``--xla_allow_excess_precision=
false``) is the yardstick the port is held to.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    storage: torch.dtype
    compute: torch.dtype
    reduce: torch.dtype

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Local inner product with the paper's FMAC semantics.

        Operands are cast to ``compute``, then upcast to ``reduce`` and
        multiplied there, so a bf16 x bf16 product is exact in f32 (the CS-1
        FMAC does not round the product before the add).
        """
        a = a.to(self.compute).to(self.reduce).reshape(-1)
        b = b.to(self.compute).to(self.reduce).reshape(-1)
        return torch.dot(a, b)


F32 = Policy("f32", torch.float32, torch.float32, torch.float32)
MIXED = Policy("bf16_mixed", torch.bfloat16, torch.bfloat16, torch.float32)
BF16_PURE = Policy("bf16_pure", torch.bfloat16, torch.bfloat16, torch.bfloat16)
F64 = Policy("f64", torch.float64, torch.float64, torch.float64)

POLICIES = {p.name: p for p in (F32, MIXED, BF16_PURE, F64)}


def get_policy(name: str) -> Policy:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown precision policy {name!r}; have {sorted(POLICIES)}") from None
