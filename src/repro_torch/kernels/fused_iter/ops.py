"""Mesh-shaped entry points of the fused passes: flatten, dispatch, reshape.

Counterpart of ``repro/kernels/fused_iter/ops.py``.  The TPU package tiles
each vector as ``(rows, 128)`` blocks of 512 rows; that is a layout for the
TPU's vector unit, not semantics, so here a contiguous block is viewed flat
(no copy; a non-contiguous operand raises) and the kernel walks it whole.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_iter import kernel


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.view(-1)


def update_q_dots(alpha, r, s, y):
    q, qy, yy = kernel.update_q_dots(alpha, _flat(r), _flat(s), _flat(y))
    return q.view(r.shape), qy, yy


def update_xr_dots(alpha, omega, x, p, q, y, r0):
    xo, ro, r0r, rr = kernel.update_xr_dots(
        alpha, omega, *(_flat(a) for a in (x, p, q, y, r0)))
    return xo.view(x.shape), ro.view(x.shape), r0r, rr


def update_p(beta, omega, r, p, s):
    return kernel.update_p(beta, omega, _flat(r), _flat(p), _flat(s)).view(r.shape)


def dot_mixed(a, b):
    return kernel.dot_mixed(_flat(a), _flat(b))
