"""The stencil SpMV kernel's wrapper (CUDA source: ``kernels/csrc/stencil_nd.cu``).

Counterpart of ``repro/kernels/stencil_nd/kernel.py:stencil_nd_pallas``
(unbatched form).  The tensor's device picks the path: a CPU tensor takes the
plain version (:func:`~repro_torch.kernels.stencil_nd.ref.stencil_nd_padded_ref`),
a CUDA tensor launches the kernel or raises.  ``launches`` counts kernel
launches only.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref

#: kernel launches in this process (CUDA tensors only)
launches = {"stencil_nd": 0}

_MAX_OFFSETS = 32      # kMaxOffsets of stencil_nd.cu


def stencil_nd(vp: torch.Tensor, coeffs: list[torch.Tensor],
               offsets: tuple[tuple[int, int, int], ...], *, radius: int,
               accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """u = A v on one r-padded block.

    ``vp``: the ``(bx+2r, by+2r, Z+2r)`` iterate with its halo; ``coeffs[i]``
    the ``(bx, by, Z)`` diagonal that multiplies the ``offsets[i]``-shifted
    window.  The unit main diagonal is implicit; products and sums run in
    ``accum_dtype`` and the result has ``vp``'s dtype.
    """
    if vp.device.type == "cpu":
        return stencil_nd_padded_ref(vp, coeffs, offsets, radius=radius,
                                     accum_dtype=accum_dtype)
    if vp.device.type != "cuda":
        raise ValueError(f"stencil_nd runs on cpu or cuda tensors, got {vp.device}")
    r = radius
    if vp.ndim != 3:
        raise ValueError(f"stencil_nd takes one 3-D padded block, got shape {tuple(vp.shape)}")
    shape = tuple(s - 2 * r for s in vp.shape)
    if min(shape) < 1:
        raise ValueError(f"padded block {tuple(vp.shape)} is empty at radius {r}")
    if len(coeffs) != len(offsets) or not 1 <= len(coeffs) <= _MAX_OFFSETS:
        raise ValueError(f"need 1..{_MAX_OFFSETS} coefficient fields, one per offset; "
                         f"got {len(coeffs)} fields and {len(offsets)} offsets")
    if any(max(abs(o) for o in off) > r for off in offsets):
        raise ValueError(f"an offset exceeds the halo radius {r}: {offsets}")
    for t in (vp, *coeffs):
        if t.device != vp.device or t.dtype != vp.dtype or not t.is_contiguous():
            raise ValueError("stencil_nd takes contiguous tensors of one dtype on one "
                             f"device; got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    for cf in coeffs:
        if tuple(cf.shape) != shape:
            raise ValueError(f"coefficient field {tuple(cf.shape)} != block {shape}")
    lib = _build.load_library()
    u = torch.empty(shape, dtype=vp.dtype, device=vp.device)
    ptrs = (ctypes.c_uint64 * len(coeffs))(*(c.data_ptr() for c in coeffs))
    offs = (ctypes.c_int * (3 * len(offsets)))(*(o for off in offsets for o in off))
    code = lib.repro_stencil_nd(
        _build.dtype_code(vp.dtype), _build.dtype_code(accum_dtype), vp.data_ptr(),
        ctypes.addressof(ptrs), ctypes.addressof(offs), len(coeffs), r,
        shape[0], shape[1], shape[2], u.data_ptr(), _build.stream_handle(vp.device))
    _build.check_launch(lib, code, "stencil_nd")
    launches["stencil_nd"] += 1
    return u
