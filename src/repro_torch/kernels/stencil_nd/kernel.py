"""The stencil SpMV kernel's wrappers (CUDA source: ``kernels/csrc/stencil_nd.cu``).

Counterpart of ``repro/kernels/stencil_nd/kernel.py:stencil_nd_pallas``:
:func:`stencil_nd` is its unbatched form (body ``_kernel``),
:func:`stencil_nd_batched` its batched form (body ``_kernel_batched``).  The
tensor's device picks the path: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.stencil_nd.ref.stencil_nd_padded_ref`), a CUDA
tensor launches the kernel or raises.  ``launches`` counts kernel launches
only, one counter per form.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref

#: kernel launches in this process (CUDA tensors only)
launches = {"stencil_nd": 0, "stencil_nd_batched": 0}

_MAX_OFFSETS = 32      # kMaxOffsets of stencil_nd.cu
_BATCHED_OFFSETS = (6, 12, 24, 26)   # the batched kernel's instantiations


def _check(what: str, vp: torch.Tensor, coeffs: list[torch.Tensor], offsets, r: int,
           nb: int) -> tuple[int, ...]:
    """Validate a CUDA launch's arguments; returns the unpadded block shape."""
    if vp.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {vp.device}")
    if vp.ndim != 3 + nb:
        raise ValueError(f"{what} takes {'a batch of ' if nb else ''}3-D padded blocks, "
                         f"got shape {tuple(vp.shape)}")
    shape = tuple(s - 2 * r for s in vp.shape[nb:])
    if min(shape) < 1:
        raise ValueError(f"padded block {tuple(vp.shape)} is empty at radius {r}")
    if len(coeffs) != len(offsets) or not 1 <= len(coeffs) <= _MAX_OFFSETS:
        raise ValueError(f"need 1..{_MAX_OFFSETS} coefficient fields, one per offset; "
                         f"got {len(coeffs)} fields and {len(offsets)} offsets")
    if any(max(abs(o) for o in off) > r for off in offsets):
        raise ValueError(f"an offset exceeds the halo radius {r}: {offsets}")
    for t in (vp, *coeffs):
        if t.device != vp.device or t.dtype != vp.dtype or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors of one dtype on one "
                             f"device; got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    for cf in coeffs:
        if tuple(cf.shape) != shape:
            raise ValueError(f"coefficient field {tuple(cf.shape)} != block {shape}")
    return shape


def _pointers(coeffs, offsets):
    ptrs = (ctypes.c_uint64 * len(coeffs))(*(c.data_ptr() for c in coeffs))
    offs = (ctypes.c_int * (3 * len(offsets)))(*(o for off in offsets for o in off))
    return ptrs, offs


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
    r = radius
    shape = _check("stencil_nd", vp, coeffs, offsets, r, 0)
    lib = _build.load_library()
    u = torch.empty(shape, dtype=vp.dtype, device=vp.device)
    ptrs, offs = _pointers(coeffs, offsets)
    code = lib.repro_stencil_nd(
        _build.dtype_code(vp.dtype), _build.dtype_code(accum_dtype), vp.data_ptr(),
        ctypes.addressof(ptrs), ctypes.addressof(offs), len(coeffs), r,
        shape[0], shape[1], shape[2], u.data_ptr(), _build.stream_handle(vp.device))
    _build.check_launch(lib, code, "stencil_nd")
    launches["stencil_nd"] += 1
    return u


def stencil_nd_batched(vp: torch.Tensor, coeffs: list[torch.Tensor],
                       offsets: tuple[tuple[int, int, int], ...], *, radius: int,
                       accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """u[b] = A v[b] for a batch of B right-hand sides in one launch.

    ``vp``: ``(B, bx+2r, by+2r, Z+2r)``; ``coeffs`` as for :func:`stencil_nd`,
    shared by every RHS; returns ``(B, bx, by, Z)``.  Each slice equals
    :func:`stencil_nd` on that slice bit for bit.  B runs from 1 to
    ``_build.MAX_BATCH`` (65535); the offsets are those of a family spec
    (6, 12, 24 or 26 of them).
    """
    if vp.device.type == "cpu":
        return stencil_nd_padded_ref(vp, coeffs, offsets, radius=radius,
                                     accum_dtype=accum_dtype)
    r = radius
    shape = _check("stencil_nd_batched", vp, coeffs, offsets, r, 1)
    if len(offsets) not in _BATCHED_OFFSETS:
        raise ValueError(f"stencil_nd_batched is built for {_BATCHED_OFFSETS} offsets "
                         f"(star7, star13, star25, box27), got {len(offsets)}")
    nb = vp.shape[0]
    if not 1 <= nb <= _build.MAX_BATCH:
        raise ValueError(f"stencil_nd_batched takes 1..{_build.MAX_BATCH} right-hand sides, "
                         f"got {nb}")
    lib = _build.load_library()
    u = torch.empty((nb,) + shape, dtype=vp.dtype, device=vp.device)
    ptrs, offs = _pointers(coeffs, offsets)
    code = lib.repro_stencil_nd_batched(
        _build.dtype_code(vp.dtype), _build.dtype_code(accum_dtype), vp.data_ptr(),
        ctypes.addressof(ptrs), ctypes.addressof(offs), len(coeffs), r, nb,
        shape[0], shape[1], shape[2], u.data_ptr(), _build.stream_handle(vp.device))
    _build.check_launch(lib, code, "stencil_nd_batched")
    launches["stencil_nd_batched"] += 1
    return u
