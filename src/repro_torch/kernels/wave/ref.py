"""Plain PyTorch version of K7, the fused leapfrog step
(``kernels/csrc/wave_leapfrog.cu``).

:func:`wave_leapfrog_ref` repeats the kernel's arithmetic op for op, each op
rounded to float32: ``acc = wc * u``, then ``acc + a_d * u[off]`` over the
radius-4 star's offsets in canonical order (``core/stencil.py``), then
``(2 u - u_prev) + c * acc``, then the source sample added at its point; ``u``
is zero outside the block.  The kernel wrapper runs it on CPU tensors, and
the card checks hold the kernel to it bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.stencil import StencilSpec

RADIUS = 4
#: the radius-4 star's offsets in canonical order: the kernel's tap order
OFFSETS = StencilSpec("star", RADIUS, 3).offsets


def wave_leapfrog_ref(u: torch.Tensor, w: torch.Tensor, c: torch.Tensor, weights,
                      src_index: int = -1, src: torch.Tensor | None = None) -> torch.Tensor:
    """``u^{n+1}`` as a new tensor from ``u`` (``u^n``), ``w`` (``u^{n-1}``)
    and ``c``, all ``(bx, by, Z)`` float32; ``weights`` = (wc, a_1 .. a_4),
    float32 values; ``src`` (a 0-d tensor) is added at flat index
    ``src_index`` when that is not negative."""
    wc, arms = float(weights[0]), [float(a) for a in weights[1:]]
    r = RADIUS
    up = F.pad(u, (r, r) * 3)
    shape = u.shape

    def window(off):
        return up[tuple(slice(r + o, r + o + n) for o, n in zip(off, shape))]

    acc = u * wc
    for off in OFFSETS:
        acc = acc + arms[max(abs(o) for o in off) - 1] * window(off)
    out = (2.0 * u - w) + c * acc
    if src_index >= 0:
        out.view(-1)[src_index] += src
    return out
