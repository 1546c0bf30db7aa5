"""Star stencils on a 3-D mesh: offsets, names and the plain apply.

A star of radius ``r`` couples each point to its neighbours at distances
1..r along each axis.  Offsets are listed axis-major, then by distance, the
``+`` side before the ``-`` side; a neighbour at distance 1 is named
``xp``/``xm`` (``yp``, ... ``zm``), one further out ``xp2``, ``xm2``, ...  The
main diagonal is 1 (the operator is Jacobi-normalised), so ``A v = v + sum_i
c_i * shift(v, off_i)``, with zero values beyond the mesh edge.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

AXES = "xyz"


def star_offsets(radius: int) -> list[tuple[str, tuple[int, int, int]]]:
    """(name, offset) of every neighbour of a radius-``radius`` star, in the
    order above."""
    out = []
    for ax in range(3):
        for dist in range(1, radius + 1):
            for sign in (1, -1):
                off = tuple(sign * dist if i == ax else 0 for i in range(3))
                name = f"{AXES[ax]}{'p' if sign > 0 else 'm'}{dist if dist > 1 else ''}"
                out.append((name, off))
    return out


def _windows(v: torch.Tensor, radius: int):
    """The zero-padded copy of ``v`` (last three axes padded by ``radius``)
    and a function giving the view of it shifted by an offset."""
    vp = F.pad(v, (radius, radius) * 3)
    shape = v.shape[-3:]
    lead = (slice(None),) * (v.ndim - 3)

    def window(off):
        return vp[lead + tuple(slice(radius + o, radius + o + n) for o, n in zip(off, shape))]

    return vp, window


def apply(fields: dict[str, torch.Tensor], offsets, v: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """``A v`` with every product and every sum rounded to ``dtype``, terms
    added in ``offsets`` order after the unit diagonal.  ``fields`` hold the
    coefficients in ``dtype`` already; ``v`` may carry a leading batch axis,
    and every right-hand side shares the fields."""
    radius = max(max(abs(o) for o in off) for _, off in offsets)
    vc = v.to(dtype)
    _, window = _windows(vc, radius)
    u = vc.clone()
    tmp = torch.empty_like(u)
    for name, off in offsets:
        torch.mul(fields[name], window(off), out=tmp)
        u.add_(tmp)
    return u


def apply_f32(fields: dict[str, torch.Tensor], offsets, v: torch.Tensor) -> torch.Tensor:
    """``A v`` in float32 from float32 fields: how the benchmark forms each
    right-hand side ``b = A x_true`` and each true residual."""
    return apply(fields, offsets, v, torch.float32)
