"""Mesh-shaped entry points of the fused passes: flatten, dispatch, reshape.

Counterpart of ``repro/kernels/fused_iter/ops.py``.  The TPU package tiles
each vector as ``(rows, 128)`` blocks of 512 rows; that is a layout for the
TPU's vector unit, not semantics, so here a contiguous block is viewed flat
(no copy; a non-contiguous operand raises) and the kernel walks it whole.
With ``batched=True`` a ``(B, ...)`` operand is viewed as ``(B, n)`` and the
batched kernel runs every RHS in one launch, with ``[B]`` scalars and ``[B]``
dot partials (the JAX package's ``batched=True``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_iter import kernel


def _flat(a: torch.Tensor, batched: bool) -> torch.Tensor:
    return a.view(a.shape[0], -1) if batched else a.view(-1)


def update_q_dots(alpha, r, s, y, *, batched: bool = False):
    fn = kernel.update_q_dots_batched if batched else kernel.update_q_dots
    q, qy, yy = fn(alpha, *(_flat(a, batched) for a in (r, s, y)))
    return q.view(r.shape), qy, yy


def update_xr_dots(alpha, omega, x, p, q, y, r0, *, batched: bool = False):
    fn = kernel.update_xr_dots_batched if batched else kernel.update_xr_dots
    xo, ro, r0r, rr = fn(alpha, omega, *(_flat(a, batched) for a in (x, p, q, y, r0)))
    return xo.view(x.shape), ro.view(x.shape), r0r, rr


def update_p(beta, omega, r, p, s, *, batched: bool = False):
    fn = kernel.update_p_batched if batched else kernel.update_p
    return fn(beta, omega, *(_flat(a, batched) for a in (r, p, s))).view(r.shape)


def dot_mixed(a, b, *, batched: bool = False):
    fn = kernel.dot_mixed_batched if batched else kernel.dot_mixed
    return fn(_flat(a, batched), _flat(b, batched))
