"""The stencil SpMV kernel's wrappers (CUDA source: ``kernels/csrc/stencil_nd.cu``).

Counterpart of ``repro/kernels/stencil_nd/kernel.py:stencil_nd_pallas``:
:func:`stencil_nd` is its unbatched form (body ``_kernel``),
:func:`stencil_nd_batched` its batched form (body ``_kernel_batched``).  The
tensor's device picks the path: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.stencil_nd.ref.stencil_nd_padded_ref`), a CUDA
tensor launches the kernel or raises.  Both forms launch one CUDA kernel
(the unbatched one with B = 1), cut into tiles, x segments and RHS chunks by
:func:`launch_plan`: today's plan, or a tuning config's x segment and RHS
chunk (``core/tuning.py:KernelConfig``, checked here before any launch).
Every plan gives the same bits.  ``launches`` counts kernel launches only,
one counter per form.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.kernels import _build
from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref

#: kernel launches in this process (CUDA tensors only)
launches = {"stencil_nd": 0, "stencil_nd_batched": 0}

#: the family specs the kernel is compiled for: (offset count, radius) ->
#: (kind, the most right-hand sides one block carries; max_chunk of stencil_nd.cu)
FAMILY = {(6, 1): ("star", 4), (12, 2): ("star", 2), (24, 4): ("star", 1), (26, 1): ("box", 4)}
TILE_Y = 16                  # kTY of stencil_nd.cu
THREADS_Z = 16               # kTZT: threads along z, each on one 16-B vector
TARGET_BLOCKS = 132 * 16     # blocks to aim for: 16 per SM of an H100
MIN_SEGMENT = 8              # fewest x planes a segment marches (each re-reads 2r)
SMEM_BYTES = 232448          # shared memory one block may use (227 KB)
MAX_GRID_X, MAX_GRID_YZ = 2 ** 31 - 1, 65535


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


def config_error(config, shape: tuple[int, int, int], n_off: int, radius: int,
                 itemsize: int) -> str | None:
    """Why the kernel cannot run ``config`` on a ``shape`` block, or None.

    The kernel takes only its compiled tile (``stencil_nd.cu`` refuses any
    other), an x segment of 1 to bx planes in at most 65535 segments, and an
    RHS chunk it has an instance for: 1 or the family spec's maximum
    (``dispatch_chunk``)."""
    tile = compiled_tile(itemsize)
    if tuple(config.tile) != tile:
        return f"tile {tuple(config.tile)} is not the compiled {tile}"
    if not 1 <= config.seg_len <= shape[0] or -(-shape[0] // config.seg_len) > MAX_GRID_YZ:
        return f"x segment {config.seg_len} does not cut bx = {shape[0]}"
    if config.chunk not in (1, FAMILY[(n_off, radius)][1]):
        return (f"RHS chunk {config.chunk} has no kernel instance (1 or "
                f"{FAMILY[(n_off, radius)][1]})")
    return None


def launch_plan(shape: tuple[int, int, int], nb: int, n_off: int, radius: int,
                itemsize: int, config=None) -> LaunchPlan:
    """The stencil kernel's launch plan for a ``shape`` block, ``nb`` RHS, a
    family spec of ``n_off`` offsets and ``radius``, and ``itemsize``-byte
    storage (counterpart of ``repro``'s ``_valid_tile``).  The tile is the
    compiled one (:func:`compiled_tile`).  ``config`` (a tuning
    ``KernelConfig``) sets the x segment, and the RHS chunk when ``nb`` is
    the batch it was chosen for (another batch keeps its default chunk);
    without one the plan aims at ``TARGET_BLOCKS`` blocks.  An invalid
    config raises."""
    if (n_off, radius) not in FAMILY:
        raise ValueError(f"the stencil kernel is built for the family specs {sorted(FAMILY)} "
                         f"(offsets, radius); got ({n_off}, {radius})")
    if itemsize not in (2, 4):
        raise ValueError(f"the stencil kernel stores bf16 or f32, got itemsize {itemsize}")
    bx, by, z = shape
    r = radius
    vz = 16 // itemsize
    ty, tz = compiled_tile(itemsize)
    if config is not None:
        problem = config_error(config, shape, n_off, r, itemsize)
        if problem:
            raise ValueError(f"stencil kernel config {config}: {problem}")
    if config is not None and nb == config.nrhs:
        chunk = config.chunk
    else:
        chunk = 1 if nb == 1 else FAMILY[(n_off, r)][1]
    tiles_y, tiles_z = -(-by // ty), -(-z // tz)
    chunks = -(-nb // chunk)
    # shared memory: a ring of 2r+2 planes of (ty+2r) rows, pitch tz + 2 vz, per RHS
    smem = min(chunk, nb) * (2 * r + 2) * (ty + 2 * r) * (tz + 2 * vz) * itemsize
    if config is not None:
        seg_len = config.seg_len
    else:
        want = -(-TARGET_BLOCKS // (tiles_y * tiles_z * chunks))
        seg_len = min(bx, max(MIN_SEGMENT, -(-bx // want)))
    return LaunchPlan(ty=ty, tz=tz, seg_len=seg_len, chunk=chunk, tiles_y=tiles_y,
                      tiles_z=tiles_z, segments=-(-bx // seg_len), chunks=chunks,
                      smem_bytes=smem)


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
    return shape


def _launch(what: str, vp: torch.Tensor, coeffs: list[torch.Tensor], offsets, r: int,
            accum_dtype: torch.dtype, batched: bool, config) -> torch.Tensor:
    """Check, plan, allocate ``u`` and launch; B = 1 for the unbatched form."""
    shape = _check(what, vp, coeffs, offsets, r, int(batched))
    nb = vp.shape[0] if batched else 1
    if not 1 <= nb <= _build.MAX_BATCH:
        raise ValueError(f"{what} takes 1..{_build.MAX_BATCH} right-hand sides, got {nb}")
    plan = launch_plan(shape, nb, len(offsets), r, vp.element_size(), config)
    lib = _build.load_library()
    u = torch.empty(vp.shape[:int(batched)] + shape, dtype=vp.dtype, device=vp.device)
    ptrs = (ctypes.c_uint64 * len(coeffs))(*(c.data_ptr() for c in coeffs))
    offs = (ctypes.c_int * (3 * len(offsets)))(*(o for off in offsets for o in off))
    code = lib.repro_stencil_nd(
        _build.dtype_code(vp.dtype), _build.dtype_code(accum_dtype), vp.data_ptr(),
        ctypes.addressof(ptrs), ctypes.addressof(offs), len(coeffs), r, nb, *shape,
        u.data_ptr(), plan.ty, plan.tz, plan.seg_len, plan.chunk,
        _build.stream_handle(vp.device))
    _build.check_launch(lib, code, what)
    launches[what] += 1
    return u


def _check_config(vp: torch.Tensor, offsets, r: int, nb: int, config) -> None:
    """On a CPU tensor, plan ``config`` anyway: it is refused on either device."""
    if config is not None:
        shape = tuple(s - 2 * r for s in vp.shape[nb:])
        launch_plan(shape, vp.shape[0] if nb else 1, len(offsets), r, vp.element_size(),
                    config)


def stencil_nd(vp: torch.Tensor, coeffs: list[torch.Tensor],
               offsets: tuple[tuple[int, int, int], ...], *, radius: int,
               accum_dtype: torch.dtype = torch.float32, config=None) -> torch.Tensor:
    """u = A v on one r-padded block.

    ``vp``: the ``(bx+2r, by+2r, Z+2r)`` iterate with its halo; ``coeffs[i]``
    the ``(bx, by, Z)`` diagonal that multiplies the ``offsets[i]``-shifted
    window, ``offsets`` a family spec's (star7, star13, star25, box27) in
    canonical order.  The unit main diagonal is implicit; products and sums
    run in ``accum_dtype`` and the result has ``vp``'s dtype.  The kernel is
    the batched one with B = 1, cut by :func:`launch_plan` under ``config``
    (None: today's plan).
    """
    if vp.device.type == "cpu":
        _check_config(vp, offsets, radius, 0, config)
        return stencil_nd_padded_ref(vp, coeffs, offsets, radius=radius,
                                     accum_dtype=accum_dtype)
    return _launch("stencil_nd", vp, coeffs, offsets, radius, accum_dtype, False, config)


def stencil_nd_batched(vp: torch.Tensor, coeffs: list[torch.Tensor],
                       offsets: tuple[tuple[int, int, int], ...], *, radius: int,
                       accum_dtype: torch.dtype = torch.float32, config=None) -> torch.Tensor:
    """u[b] = A v[b] for a batch of B right-hand sides in one launch.

    ``vp``: ``(B, bx+2r, by+2r, Z+2r)``; ``coeffs`` as for :func:`stencil_nd`,
    shared by every RHS; returns ``(B, bx, by, Z)``.  Each slice equals
    :func:`stencil_nd` on that slice bit for bit.  B runs from 1 to
    ``_build.MAX_BATCH`` (65535); the offsets as for :func:`stencil_nd`.
    """
    if vp.device.type == "cpu":
        _check_config(vp, offsets, radius, 1, config)
        return stencil_nd_padded_ref(vp, coeffs, offsets, radius=radius,
                                     accum_dtype=accum_dtype)
    return _launch("stencil_nd_batched", vp, coeffs, offsets, radius, accum_dtype, True,
                   config)
