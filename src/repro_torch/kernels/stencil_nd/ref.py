"""Plain PyTorch versions of the stencil kernels.

:func:`stencil_nd_ref` is the counterpart of the JAX package's
``kernels/stencil_nd/ref.py:stencil_nd_ref`` (zero-Dirichlet block, ordered
coefficient list).  :func:`stencil_nd_padded_ref` takes the CUDA kernel's own
argument layout (the r-padded block, or a batch of them) and repeats its
arithmetic op for op; :func:`stencil7_dots_padded_ref` does the same for the
7-point SpMV with its dot epilogue.  The kernel wrappers run these on CPU
tensors, and the card checks compare the kernels against them (vectors bit
for bit).
"""

from __future__ import annotations

import torch

from repro_torch.core.stencil import _shift_nd


def stencil_nd_ref(v: torch.Tensor, coeffs: list[torch.Tensor], offsets,
                   accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """coeffs[i] multiplies the offsets[i]-shifted iterate (kernel order)."""
    vc = v.to(accum_dtype)
    u = vc
    for cf, off in zip(coeffs, offsets):
        u = u + cf.to(accum_dtype) * _shift_nd(vc, off)
    return u.to(v.dtype)


def _padded_accumulate(vp: torch.Tensor, coeffs: list[torch.Tensor], offsets, radius: int,
                       accum_dtype: torch.dtype) -> torch.Tensor:
    """The SpMV's accumulator, in ``accum_dtype``: unit diagonal, then
    ``u + c_i * window(off_i)`` in the given order over the last three axes
    of the r-padded ``vp``; leading (batch) axes share the coefficients."""
    r = radius
    nb = vp.ndim - len(offsets[0])
    shape = tuple(s - 2 * r for s in vp.shape[nb:])
    win = lambda off: vp[(slice(None),) * nb
                         + tuple(slice(r + o, r + o + n) for o, n in zip(off, shape))]
    u = win((0,) * len(shape)).to(accum_dtype)
    for cf, off in zip(coeffs, offsets):
        u = u + cf.to(accum_dtype) * win(off).to(accum_dtype)
    return u


def stencil_nd_padded_ref(vp: torch.Tensor, coeffs: list[torch.Tensor], offsets, *,
                          radius: int, accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """u = A v from an r-padded block ``(bx+2r, by+2r, Z+2r) -> (bx, by, Z)``,
    or from a batch ``(B, ...) -> (B, bx, by, Z)``: unit diagonal, then
    ``u + c_i * window(off_i)`` in the given order, each op rounded to
    ``accum_dtype``, the result cast to ``vp``'s dtype."""
    return _padded_accumulate(vp, coeffs, offsets, radius, accum_dtype).to(vp.dtype)


def stencil7_dots_padded_ref(vp: torch.Tensor, w: torch.Tensor | None,
                             coeffs: list[torch.Tensor], offsets, *, two_dots: bool,
                             accum_dtype: torch.dtype = torch.float32):
    """(u, <w,u>, <u,u> or None) from the 1-padded block: ``u`` as
    :func:`stencil_nd_padded_ref`, the dots in f32 from the unrounded
    accumulator and the upcast ``w``; ``w=None`` is the interior of ``vp``."""
    if w is None:
        w = vp[1:-1, 1:-1, 1:-1]
    acc = _padded_accumulate(vp, coeffs, offsets, 1, accum_dtype)
    uf = acc.to(torch.float32)
    d1 = (w.to(torch.float32) * uf).sum()
    return acc.to(vp.dtype), d1, (uf * uf).sum() if two_dots else None
