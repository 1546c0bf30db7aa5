"""The stencil SpMV kernel's wrappers (CUDA source: ``kernels/csrc/stencil_nd.cu``).

Counterpart of ``repro/kernels/stencil_nd/kernel.py:stencil_nd_pallas``:
:func:`stencil_nd` is its unbatched form (body ``_kernel``),
:func:`stencil_nd_batched` its batched form (body ``_kernel_batched``).  Both
take the iterate in either of two forms, told apart by its shape against the
coefficient fields': the r-padded block (the multi-rank halo exchange's) or
the bare block, whose zero halo the kernel stages itself, so a one-rank
SpMV makes no padded copy.  Any other shape raises.  The tensor's device
picks the path: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.stencil_nd.ref.stencil_nd_padded_ref` for the
padded form, :func:`~repro_torch.kernels.stencil_nd.ref.stencil_nd_ref` for
the bare one), a CUDA tensor launches the kernel or raises.  Both wrappers
launch one CUDA kernel (the unbatched one with B = 1), cut into tiles, x
segments and RHS chunks by :func:`launch_plan`, the one place that decides
the cut.  Every plan gives the same bits.
:func:`stencil_nd_axpy` is BiCGStab's second SpMV with its input unformed:
``A (r - st(alpha) s)``, the kernel forming each plane of the input as it
stages it, so that input never reaches device memory.  ``launches`` counts
kernel launches only, one counter per wrapper; ``rhs`` counts the
right-hand sides the batched wrapper's launches served.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.kernels import _build
from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref, stencil_nd_ref

#: kernel launches in this process (CUDA tensors only)
launches = {"stencil_nd": 0, "stencil_nd_batched": 0, "stencil_nd_axpy": 0}
#: right-hand sides served by those launches (CUDA tensors only), the batched wrapper's
rhs = {"stencil_nd_batched": 0}

#: the family specs the kernel is compiled for: (offset count, radius) ->
#: (kind, the most right-hand sides one block carries; max_chunk of stencil_nd.cu)
FAMILY = {(6, 1): ("star", 4), (12, 2): ("star", 2), (24, 4): ("star", 1), (26, 1): ("box", 4)}
TILE_Y = 16                  # kTY of stencil_nd.cu
THREADS_Z = 16               # kTZT: threads along z, each on one 16-B vector
TARGET_BLOCKS = 132 * 16     # blocks to aim for: 16 per SM of an H100
MIN_SEGMENT = 8              # fewest x planes a segment marches (each re-reads 2r)
SMEM_BYTES = 232448          # shared memory one block may use (227 KB)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the stencil kernel cuts a ``(B, bx, by, Z)`` launch: (y, z) tiles
    of ``ty x tz`` points, x segments of ``seg_len`` planes, and chunks of
    ``chunk`` right-hand sides; each block takes one tile, one segment and one
    chunk.  Every plan gives the same bits (each output is a canonical-order
    sum over the offsets)."""
    ty: int
    tz: int
    seg_len: int
    chunk: int
    tiles_y: int
    tiles_z: int
    segments: int
    chunks: int
    smem_bytes: int

    @property
    def grid(self) -> tuple[int, int, int]:
        return (self.tiles_y * self.tiles_z, self.segments, self.chunks)

    @property
    def blocks(self) -> int:
        """Blocks of the grid: one dot partial each in the SpMV+dot kernel."""
        return self.tiles_y * self.tiles_z * self.segments * self.chunks


def compiled_tile(itemsize: int) -> tuple[int, int]:
    """The (ty, tz) tile stencil_nd.cu is compiled for: 16 rows by 16 threads
    of one 16-B vector each along z."""
    return TILE_Y, THREADS_Z * (16 // itemsize)


def launch_plan(shape: tuple[int, int, int], nb: int, n_off: int, radius: int,
                itemsize: int, *, axpy: bool = False) -> LaunchPlan:
    """The stencil kernel's launch plan for a ``shape`` block, ``nb`` RHS, a
    family spec of ``n_off`` offsets and ``radius``, and ``itemsize``-byte
    storage (counterpart of ``repro``'s ``_valid_tile``).  The tile is the
    compiled one (:func:`compiled_tile`), the RHS chunk 1 for one RHS and
    the family's maximum otherwise, and the x segments aim at
    ``TARGET_BLOCKS`` blocks.  ``axpy``: the form that stages
    ``r - st(alpha) s`` (:func:`stencil_nd_axpy`), whose shared memory
    holds one more plane, of ``s``."""
    if (n_off, radius) not in FAMILY:
        raise ValueError(f"the stencil kernel is built for the family specs {sorted(FAMILY)} "
                         f"(offsets, radius); got ({n_off}, {radius})")
    if itemsize not in (2, 4):
        raise ValueError(f"the stencil kernel stores bf16 or f32, got itemsize {itemsize}")
    bx, by, z = shape
    r = radius
    vz = 16 // itemsize
    ty, tz = compiled_tile(itemsize)
    chunk = 1 if nb == 1 else FAMILY[(n_off, r)][1]
    tiles_y, tiles_z = -(-by // ty), -(-z // tz)
    chunks = -(-nb // chunk)
    # shared memory: a ring of 2r+2 planes of (ty+2r) rows, pitch tz + 2 vz, per RHS,
    # and the axpy form's plane of s
    plane = (ty + 2 * r) * (tz + 2 * vz) * itemsize
    smem = (min(chunk, nb) * (2 * r + 2) + int(axpy)) * plane
    want = -(-TARGET_BLOCKS // (tiles_y * tiles_z * chunks))
    seg_len = min(bx, max(MIN_SEGMENT, -(-bx // want)))
    return LaunchPlan(ty=ty, tz=tz, seg_len=seg_len, chunk=chunk, tiles_y=tiles_y,
                      tiles_z=tiles_z, segments=-(-bx // seg_len), chunks=chunks,
                      smem_bytes=smem)


def _form(what: str, vp: torch.Tensor, coeffs: list[torch.Tensor], r: int,
          nb: int) -> tuple[tuple[int, ...], bool]:
    """The block's shape (the coefficient fields') and whether ``vp`` is the
    bare block (else the r-padded one); any other shape raises."""
    shape = tuple(coeffs[0].shape) if coeffs else ()
    mesh = tuple(vp.shape[nb:])
    if len(shape) == 3 and vp.ndim == 3 + nb:
        if mesh == shape:
            return shape, True
        if mesh == tuple(s + 2 * r for s in shape):
            return shape, False
    raise ValueError(f"{what} takes {'a batch of ' if nb else ''}3-D blocks, bare {shape} "
                     f"or padded by r = {r}; got {tuple(vp.shape)}")


def _check(what: str, vp: torch.Tensor, coeffs: list[torch.Tensor], offsets, r: int,
           nb: int) -> tuple[tuple[int, ...], bool]:
    """Validate a CUDA launch's arguments; returns the block shape and
    whether ``vp`` is bare."""
    if vp.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {vp.device}")
    shape, bare = _form(what, vp, coeffs, r, nb)
    if min(shape) < 1:
        raise ValueError(f"block {tuple(vp.shape)} is empty")
    if len(coeffs) != len(offsets):
        raise ValueError(f"need one coefficient field per offset; got {len(coeffs)} fields "
                         f"and {len(offsets)} offsets")
    kind = FAMILY.get((len(offsets), r), ("", 0))[0]
    if not kind or tuple(map(tuple, offsets)) != StencilSpec(kind, r, 3).offsets:
        raise ValueError(f"{what} is built for the family specs (star7, star13, star25, "
                         f"box27) in canonical offset order; got {len(offsets)} offsets at "
                         f"radius {r}: {offsets}")
    for t in (vp, *coeffs):
        if t.device != vp.device or t.dtype != vp.dtype or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors of one dtype on one "
                             f"device; got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    for cf in coeffs:
        if tuple(cf.shape) != shape:
            raise ValueError(f"coefficient field {tuple(cf.shape)} != block {shape}")
    return shape, bare


def _apply(what: str, vp: torch.Tensor, coeffs: list[torch.Tensor], offsets, r: int,
           accum_dtype: torch.dtype, batched: bool) -> torch.Tensor:
    """The plain version on a CPU tensor, else check, plan, allocate ``u``
    and launch; B = 1 for the unbatched form."""
    if vp.device.type == "cpu":
        _, bare = _form(what, vp, coeffs, r, int(batched))
        if bare:
            return stencil_nd_ref(vp, coeffs, offsets, accum_dtype=accum_dtype)
        return stencil_nd_padded_ref(vp, coeffs, offsets, radius=r, accum_dtype=accum_dtype)
    return _launch(what, vp, coeffs, offsets, r, accum_dtype, batched)


def _launch(what: str, vp: torch.Tensor, coeffs: list[torch.Tensor], offsets, r: int,
            accum_dtype: torch.dtype, batched: bool) -> torch.Tensor:
    """Check, plan, allocate ``u``, launch and count; B = 1 for the
    unbatched form."""
    shape, bare = _check(what, vp, coeffs, offsets, r, int(batched))
    nb = vp.shape[0] if batched else 1
    if not 1 <= nb <= _build.MAX_BATCH:
        raise ValueError(f"{what} takes 1..{_build.MAX_BATCH} right-hand sides, got {nb}")
    plan = launch_plan(shape, nb, len(offsets), r, vp.element_size())
    lib = _build.load_library()
    u = torch.empty(vp.shape[:int(batched)] + shape, dtype=vp.dtype, device=vp.device)
    ptrs = (ctypes.c_uint64 * len(coeffs))(*(c.data_ptr() for c in coeffs))
    offs = (ctypes.c_int * (3 * len(offsets)))(*(o for off in offsets for o in off))
    code = lib.repro_stencil_nd(
        _build.dtype_code(vp.dtype), _build.dtype_code(accum_dtype), vp.data_ptr(), int(bare),
        ctypes.addressof(ptrs), ctypes.addressof(offs), len(coeffs), r, nb, *shape,
        u.data_ptr(), plan.ty, plan.tz, plan.seg_len, plan.chunk,
        _build.stream_handle(vp.device))
    _build.check_launch(lib, code, what)
    launches[what] += 1
    if what in rhs:
        rhs[what] += nb
    return u


def stencil_nd(vp: torch.Tensor, coeffs: list[torch.Tensor],
               offsets: tuple[tuple[int, int, int], ...], *, radius: int,
               accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """u = A v on one block.

    ``vp``: the bare ``(bx, by, Z)`` iterate, zero outside the block, or the
    ``(bx+2r, by+2r, Z+2r)`` one with its halo; ``coeffs[i]`` the ``(bx, by, Z)`` diagonal that
    multiplies the ``offsets[i]``-shifted window, ``offsets`` a family
    spec's (star7, star13, star25, box27) in canonical order.  The unit main
    diagonal is implicit; products and sums run in ``accum_dtype`` and the
    result has ``vp``'s dtype.  The bare form equals the padded form on the
    zero-padded block bit for bit.  The kernel is the batched one with B = 1,
    cut by :func:`launch_plan`.
    """
    return _apply("stencil_nd", vp, coeffs, offsets, radius, accum_dtype, False)


def axpy_staged(shape: tuple[int, ...], itemsize: int) -> bool:
    """Whether the kernel forms :func:`stencil_nd_axpy`'s input itself on a
    bare block of ``shape``: its 16-B staging, so Z a whole number of 16-B
    vectors (the operands must also start on 16-B boundaries)."""
    return shape[-1] % (16 // itemsize) == 0


def stencil_nd_axpy(alpha: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
                    coeffs: list[torch.Tensor], offsets: tuple[tuple[int, int, int], ...], *,
                    radius: int, accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y = A q with q = r - st(alpha) s: BiCGStab's second SpMV on one bare
    block, its input formed by the kernel as it stages each plane.

    ``alpha`` is a 0-d (or one-element) f32 tensor on ``r``'s device, read by
    the kernel and rounded there to the storage dtype; ``r`` and ``s`` are the
    bare ``(bx, by, Z)`` block; the rest as for :func:`stencil_nd`.  ``q``
    is formed as ``update_q_dots`` forms it, each op rounded to the storage
    dtype, so ``y`` equals :func:`stencil_nd` on ``r - alpha.to(r.dtype) * s``
    bit for bit.  A CPU tensor takes the plain version of both.  On the card
    the kernel stages 16-B vectors: Z not a whole number of them
    (:func:`axpy_staged`), or an operand off a 16-B boundary, raises.
    """
    if tuple(r.shape) != tuple(s.shape) or r.dtype != s.dtype:
        raise ValueError(f"stencil_nd_axpy takes r and s of one shape and dtype; got "
                         f"{r.dtype}{tuple(r.shape)} and {s.dtype}{tuple(s.shape)}")
    shape, bare = _form("stencil_nd_axpy", r, coeffs, radius, 0)
    if not bare:
        raise ValueError(f"stencil_nd_axpy takes the bare block {shape}; got {tuple(r.shape)}")
    if r.device.type == "cpu":
        return stencil_nd(r - alpha.to(r.dtype) * s, coeffs, offsets, radius=radius,
                          accum_dtype=accum_dtype)
    for v in (r, s):
        _check("stencil_nd_axpy", v, coeffs, offsets, radius, 0)
    if not axpy_staged(shape, r.element_size()) or r.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError(f"stencil_nd_axpy stages 16-B vectors: Z a multiple of "
                         f"{16 // r.element_size()} and r, s 16-B aligned; got Z = {shape[-1]}, "
                         f"r at {r.data_ptr() % 16}, s at {s.data_ptr() % 16} mod 16")
    if alpha.dtype != torch.float32 or alpha.numel() != 1 or alpha.device != r.device:
        raise ValueError(f"stencil_nd_axpy takes alpha as one f32 on {r.device}; got "
                         f"{alpha.dtype}{tuple(alpha.shape)} on {alpha.device}")
    plan = launch_plan(shape, 1, len(offsets), radius, r.element_size(), axpy=True)
    lib = _build.load_library()
    alpha = alpha.contiguous()
    u = torch.empty(shape, dtype=r.dtype, device=r.device)
    ptrs = (ctypes.c_uint64 * len(coeffs))(*(c.data_ptr() for c in coeffs))
    offs = (ctypes.c_int * (3 * len(offsets)))(*(o for off in offsets for o in off))
    code = lib.repro_stencil_nd_axpy(
        _build.dtype_code(r.dtype), _build.dtype_code(accum_dtype), r.data_ptr(), s.data_ptr(),
        alpha.data_ptr(), ctypes.addressof(ptrs), ctypes.addressof(offs), len(coeffs), radius,
        *shape, u.data_ptr(), plan.ty, plan.tz, plan.seg_len, _build.stream_handle(r.device))
    _build.check_launch(lib, code, "stencil_nd_axpy")
    launches["stencil_nd_axpy"] += 1
    return u


def stencil_nd_batched(vp: torch.Tensor, coeffs: list[torch.Tensor],
                       offsets: tuple[tuple[int, int, int], ...], *, radius: int,
                       accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """u[b] = A v[b] for a batch of B right-hand sides in one launch.

    ``vp``: ``(B, bx, by, Z)`` bare or ``(B, bx+2r, by+2r, Z+2r)`` padded;
    ``coeffs`` as for :func:`stencil_nd`, shared by every RHS; returns
    ``(B, bx, by, Z)``.  Each slice equals :func:`stencil_nd` on that slice
    bit for bit.  B runs from 1 to ``_build.MAX_BATCH`` (65535); the offsets
    as for :func:`stencil_nd`.
    """
    return _apply("stencil_nd_batched", vp, coeffs, offsets, radius, accum_dtype, True)
