"""Fused epilogues: the overlap schedule's boundary-ring fold, and the 7-point
SpMV with a dot epilogue (CUDA source: ``kernels/csrc/stencil7_dot.cu``).

Counterpart of ``repro/kernels/stencil_nd/fused.py``.

**Boundary-ring fold** (:func:`fused_ring_apply`): the overlap schedule's
split form runs the stencil kernel on the zero-padded block and once more
per boundary region; the fused form runs it once over the exchanged block.
The tuning cache picks the form per cell (``KernelConfig.fuse_ring``).

**Dot epilogues**, the kernel behind ``core/bicgstab.py:solve_ref_fused``:

* :func:`stencil7_dot`: ``s = A p`` and ``<r0, s>`` (BiCGStab's sync point 1);
* :func:`stencil7_two_dots`: ``y = A q``, ``<q, y>`` and ``<y, y>`` (sync point 2).

The SpMV accumulates in ``accum_dtype`` (f32 by default, as in the JAX
package) and rounds to the storage dtype for the write; the dots are taken
in f32 from the unrounded accumulator.  With the same accumulation dtype the
vector equals the stencil_nd kernel's bit for bit.  The block is zero-padded
here (``F.pad``), as the JAX wrapper pads before its kernel, and
:func:`stencil7_dots_padded` is the kernel's own wrapper on the padded
block: a CPU tensor takes the plain version
(``ref.stencil7_dots_padded_ref``), a CUDA tensor launches the kernel or
raises.  K6 keeps its fixed plan (the star7 ``launch_plan`` for one RHS):
its dot partials are one per block, so another plan would sum them in
another order, and the JAX package's K6 does not read the tuning cache
either.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.stencil import STAR7, StencilCoeffs
from repro_torch.kernels import _build
from repro_torch.kernels.stencil_nd.kernel import launch_plan
from repro_torch.kernels.stencil_nd.ref import stencil7_dots_padded_ref

#: kernel launches in this process (CUDA tensors only), both variants
launches = {"stencil7_dot": 0}


def fused_ring_apply(exchange, cf_list: list[torch.Tensor], spec, config, *,
                     accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One-launch overlapped SpMV: interior and boundary ring in one pass of
    the stencil kernel over the *exchanged* r-padded block.

    Bitwise the split form (interior kernel + ring patches): a cell off the
    ring never reads a halo value, so its sum is the same over the
    zero-padded and the exchanged block, and a ring cell sums exactly the
    terms the patch kernel sums from the same slabs.  One launch per SpMV,
    where the split form makes 1 + one per boundary region."""
    from repro_torch.kernels.stencil_nd.kernel import stencil_nd, stencil_nd_batched

    if exchange.radius != spec.radius:
        raise ValueError(f"exchange radius {exchange.radius} != spec radius {spec.radius}")
    launch = stencil_nd_batched if exchange.n_batch else stencil_nd
    return launch(exchange.padded, cf_list, spec.offsets, radius=spec.radius,
                  accum_dtype=accum_dtype, config=config)


def stencil7_dots_padded(vp: torch.Tensor, w: torch.Tensor | None, cfs: list[torch.Tensor], *,
                         two_dots: bool, accum_dtype: torch.dtype = torch.float32):
    """The kernel on a 1-padded block: ``(u, <w,u>, <u,u> or None)`` with
    ``u = A v``, ``vp`` the ``(bx+2, by+2, Z+2)`` iterate and ``cfs`` the six
    ``(bx, by, Z)`` fields in STAR7 order, all of one dtype.  The one-dot
    variant takes ``w``; the two-dot variant takes ``w=None``, which means
    the interior of ``vp`` (``v`` itself, as in ``<q, Aq>``), read from the
    plane the kernel already holds."""
    if (w is None) != two_dots:
        raise ValueError("the one-dot variant takes w; the two-dot variant takes w=None "
                         "(w is v itself)")
    if vp.device.type == "cpu":
        return stencil7_dots_padded_ref(vp, w, cfs, STAR7.offsets, two_dots=two_dots,
                                        accum_dtype=accum_dtype)
    if vp.device.type != "cuda":
        raise ValueError(f"stencil7 dots run on cpu or cuda tensors, got {vp.device}")
    return _launch(vp, w, cfs, two_dots, accum_dtype)


def _launch(vp: torch.Tensor, w: torch.Tensor | None, cfs: list[torch.Tensor], two_dots: bool,
            accum_dtype: torch.dtype):
    """Check, plan, allocate ``u`` and the partials, launch and count.  The
    scratch holds one partial per block of the plan, and the entry point
    refuses a plan whose grid is not that many blocks."""
    shape = tuple(s - 2 for s in vp.shape)
    if vp.ndim != 3 or min(shape) < 1 or len(cfs) != 6:
        raise ValueError(f"stencil7 dots take one 1-padded 3-D block and 6 fields; got "
                         f"{tuple(vp.shape)} and {len(cfs)} fields")
    others = cfs if w is None else [w, *cfs]
    for t in (vp, *others):
        if t.dtype != vp.dtype or t.device != vp.device or not t.is_contiguous():
            raise ValueError(f"stencil7 dots take contiguous tensors of one dtype and device; "
                             f"got {t.dtype} on {t.device} vs {vp.dtype} on {vp.device}")
    for t in others:
        if tuple(t.shape) != shape:
            raise ValueError(f"w and the fields must be {shape}, got {tuple(t.shape)}")
    plan = launch_plan(shape, 1, 6, 1, vp.element_size())
    lib = _build.load_library()
    n_dots = 2 if two_dots else 1
    u = torch.empty(shape, dtype=vp.dtype, device=vp.device)
    part = torch.empty(plan.blocks * n_dots, dtype=torch.float32, device=vp.device)
    out = torch.empty(n_dots, dtype=torch.float32, device=vp.device)
    ptrs = (ctypes.c_uint64 * 6)(*(c.data_ptr() for c in cfs))
    code = lib.repro_stencil7_dot(
        _build.dtype_code(vp.dtype), _build.dtype_code(accum_dtype), vp.data_ptr(),
        None if w is None else w.data_ptr(), ctypes.addressof(ptrs), n_dots, *shape,
        u.data_ptr(), plan.ty, plan.tz, plan.seg_len, plan.blocks, part.data_ptr(),
        out.data_ptr(), _build.stream_handle(vp.device))
    _build.check_launch(lib, code, "stencil7_dot")
    launches["stencil7_dot"] += 1
    return u, out[0], out[1] if two_dots else None


def _call(coeffs: StencilCoeffs, v: torch.Tensor, w: torch.Tensor | None, *, two_dots: bool,
          accum_dtype: torch.dtype):
    if coeffs.spec != STAR7 or coeffs.diag is not None:
        raise ValueError("the dot-epilogue kernel is the unit-diagonal 7-point stencil; got "
                         f"{coeffs.spec.name}{'' if coeffs.diag is None else ' (raw diagonal)'}")
    cfs = [coeffs.diags[n] for n in STAR7.names]
    for t in cfs if w is None else (w, *cfs):
        if t.dtype != v.dtype or t.shape != v.shape:
            raise ValueError(f"coefficients and w must match v ({v.dtype}{tuple(v.shape)}); "
                             f"got {t.dtype}{tuple(t.shape)}")
    return stencil7_dots_padded(F.pad(v, (1, 1) * 3), w, cfs, two_dots=two_dots,
                                accum_dtype=accum_dtype)


def stencil7_dot(coeffs: StencilCoeffs, p: torch.Tensor, r0: torch.Tensor, *,
                 accum_dtype: torch.dtype = torch.float32):
    """s = A p, <r0, s> in one pass.  Returns (s, r0s partial)."""
    s, d1, _ = _call(coeffs, p, r0, two_dots=False, accum_dtype=accum_dtype)
    return s, d1


def stencil7_two_dots(coeffs: StencilCoeffs, q: torch.Tensor, *,
                      accum_dtype: torch.dtype = torch.float32):
    """y = A q, <q, y>, <y, y> in one pass.  Returns (y, qy, yy).  ``q`` is
    the SpMV's own iterate, so the kernel takes it from the padded copy."""
    return _call(coeffs, q, None, two_dots=True, accum_dtype=accum_dtype)
