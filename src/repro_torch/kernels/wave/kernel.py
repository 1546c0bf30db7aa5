"""K7's wrapper (CUDA source: ``kernels/csrc/wave_leapfrog.cu``): one leapfrog
step of the constant-density acoustic wave equation with the 8th-order
(radius-4, 25-point) Laplacian, in place.

K7 replaces no TPU kernel: the JAX package has no explicit time-stepper.
``core/wave.py:propagate_shot`` launches it once a step.  The tensor's
device picks the path: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.wave.ref.wave_leapfrog_ref`), a CUDA tensor
launches the kernel or raises.  The launch is cut by the stencil kernel's
plan for star25 in float32 and one right-hand side
(``kernels/stencil_nd/kernel.py:launch_plan``): K7 marches K1's ring, so the
tiles, x segments and shared memory are K1's.  ``launches`` counts kernel
launches only.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil_nd import kernel as stencil_kernel
from repro_torch.kernels.wave.ref import OFFSETS, RADIUS, wave_leapfrog_ref

#: kernel launches in this process (CUDA tensors only)
launches = {"wave_leapfrog": 0}


def launch_plan(shape: tuple[int, int, int]) -> stencil_kernel.LaunchPlan:
    """K7's plan for a ``(bx, by, Z)`` block: K1's default star25 float32 plan
    for one right-hand side (nothing sweeps K7)."""
    return stencil_kernel.launch_plan(tuple(int(s) for s in shape), 1, len(OFFSETS), RADIUS, 4)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def _check(u: torch.Tensor, w: torch.Tensor, c: torch.Tensor, weights, src_index: int,
           src) -> None:
    shape = tuple(u.shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"wave_leapfrog takes a non-empty 3-D block, got {shape}")
    for name, t in (("u", u), ("w", w), ("c", c)):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != u.device
                or not t.is_contiguous()):
            raise ValueError(f"wave_leapfrog takes contiguous float32 u, w and c of one shape "
                             f"on one device; {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} (contiguous={t.is_contiguous()}), u {shape}")
    if len(weights) != 1 + RADIUS:
        raise ValueError(f"wave_leapfrog takes {1 + RADIUS} weights (wc, a_1 .. a_4), "
                         f"got {len(weights)}")
    if src_index >= 0:
        if src_index >= u.numel():
            raise ValueError(f"source index {src_index} is outside the block {shape}")
        if src is None or src.numel() != 1 or src.dtype != torch.float32 \
                or src.device != u.device:
            raise ValueError("a source needs its sample as one float32 element on u's device")
    if _overlap(w, u) or _overlap(w, c):
        raise ValueError("wave_leapfrog writes w in place: w may overlap neither u nor c")


def wave_leapfrog(u: torch.Tensor, w: torch.Tensor, c: torch.Tensor, *, weights,
                  src_index: int = -1, src: torch.Tensor | None = None,
                  plan: stencil_kernel.LaunchPlan | None = None) -> torch.Tensor:
    """One step in place: ``w`` holds ``u^{n-1}`` and receives ``u^{n+1}``,
    which is returned; ``u`` (``u^n``) and ``c`` are read.

    ``weights`` = (wc, a_1 .. a_4), float32 values (wc = 3 a_0);
    ``src`` is the source sample (a float32 tensor of one element, on the
    card for a card launch, read there by the kernel: no host wait), added at
    flat index ``src_index`` (negative: no source).  ``plan``: a
    :func:`launch_plan` (None: the default).
    """
    _check(u, w, c, weights, src_index, src)
    if u.device.type == "cpu":                       # the plain version: no plan, no launch
        return w.copy_(wave_leapfrog_ref(u, w, c, weights, src_index,
                                         src.reshape(()) if src_index >= 0 else None))
    if u.device.type != "cuda":
        raise ValueError(f"wave_leapfrog runs on cpu or cuda tensors, got {u.device}")
    shape = tuple(u.shape)
    plan = plan if plan is not None else launch_plan(shape)
    lib = _build.load_library()
    wts = (ctypes.c_float * len(weights))(*(float(a) for a in weights))
    code = lib.repro_wave_leapfrog(
        u.data_ptr(), w.data_ptr(), c.data_ptr(), src.data_ptr() if src_index >= 0 else None,
        int(src_index), ctypes.addressof(wts), *shape, plan.ty, plan.tz, plan.seg_len,
        _build.stream_handle(u.device))
    _build.check_launch(lib, code, "wave_leapfrog")
    launches["wave_leapfrog"] += 1
    return w
