"""Plain PyTorch versions of the stencil kernel.

:func:`stencil_nd_ref` is the counterpart of the JAX package's
``kernels/stencil_nd/ref.py:stencil_nd_ref`` (zero-Dirichlet block, ordered
coefficient list).  :func:`stencil_nd_padded_ref` takes the CUDA kernel's own
argument layout (the r-padded block) and repeats its arithmetic op for op:
the kernel wrapper runs it on CPU tensors, and the card checks compare the
kernel against it bit for bit.
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


def stencil_nd_padded_ref(vp: torch.Tensor, coeffs: list[torch.Tensor], offsets, *,
                          radius: int, accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """u = A v from an r-padded block ``(bx+2r, by+2r, Z+2r) -> (bx, by, Z)``:
    unit diagonal, then ``u + c_i * window(off_i)`` in the given order, each op
    rounded to ``accum_dtype``, the result cast to ``vp``'s dtype."""
    r = radius
    shape = tuple(s - 2 * r for s in vp.shape)
    win = lambda off: vp[tuple(slice(r + o, r + o + n) for o, n in zip(off, shape))]
    u = win((0,) * len(shape)).to(accum_dtype)
    for cf, off in zip(coeffs, offsets):
        u = u + cf.to(accum_dtype) * win(off).to(accum_dtype)
    return u.to(vp.dtype)
