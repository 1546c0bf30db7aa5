"""Wrappers of the fused BiCGStab passes (CUDA source: ``kernels/csrc/fused_iter.cu``).

Counterparts of ``repro/kernels/fused_iter/kernel.py``: ``update_q_dots_pallas``,
``update_xr_dots_pallas``, ``update_p_pallas`` and ``dot_mixed_pallas``
(unbatched forms).  Each takes flat contiguous vectors; a CPU tensor takes
the plain version in ``ref.py``, a CUDA tensor launches the kernel or raises.
Scalars go in as 0-d f32 tensors on the vectors' device, read by the kernel
through a pointer.  Dot partials come back as 0-d f32 tensors.  ``launches``
counts one per kernel call (the call's fixed-order partial-sum pass
included), CUDA tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_iter import ref

#: kernel launches in this process (CUDA tensors only)
launches = {"update_q_dots": 0, "update_xr_dots": 0, "update_p": 0, "dot_mixed": 0}


def _on_cuda(what: str, *vectors: torch.Tensor) -> bool:
    """True for CUDA tensors (after checking them), False for CPU tensors."""
    first = vectors[0]
    if first.device.type == "cpu":
        return False
    if first.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {first.device}")
    _build.dtype_code(first.dtype)
    for t in vectors:
        if (t.device != first.device or t.dtype != first.dtype or t.ndim != 1
                or t.shape != first.shape or not t.is_contiguous()):
            raise ValueError(
                f"{what} takes flat contiguous vectors of one shape, dtype and device; "
                f"got {t.dtype}{tuple(t.shape)} on {t.device} vs "
                f"{first.dtype}{tuple(first.shape)} on {first.device}")
    if first.numel() == 0:
        raise ValueError(f"{what}: empty vectors")
    return True


def _scalar(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(())


def _dot_buffers(lib, n: int, n_dots: int, device: torch.device):
    part = torch.empty(lib.repro_reduce_blocks(n) * n_dots, dtype=torch.float32, device=device)
    out = torch.empty(n_dots, dtype=torch.float32, device=device)
    return part, out


def update_q_dots(alpha, r, s, y):
    """(q, <q,y>, <y,y>) with q = r - st(alpha)*s."""
    if not _on_cuda("update_q_dots", r, s, y):
        return ref.update_q_dots_ref(alpha, r, s, y)
    lib = _build.load_library()
    a = _scalar(alpha, r.device)
    q = torch.empty_like(r)
    part, out = _dot_buffers(lib, r.numel(), 2, r.device)
    code = lib.repro_update_q_dots(
        _build.dtype_code(r.dtype), a.data_ptr(), r.data_ptr(), s.data_ptr(), y.data_ptr(),
        q.data_ptr(), part.data_ptr(), out.data_ptr(), r.numel(),
        _build.stream_handle(r.device))
    _build.check_launch(lib, code, "update_q_dots")
    launches["update_q_dots"] += 1
    return q, out[0], out[1]


def update_xr_dots(alpha, omega, x, p, q, y, r0):
    """(x', r', <r0,r'>, <r',r'>) with x' = x + st(alpha)*p + st(omega)*q,
    r' = q - st(omega)*y."""
    if not _on_cuda("update_xr_dots", x, p, q, y, r0):
        return ref.update_xr_dots_ref(alpha, omega, x, p, q, y, r0)
    lib = _build.load_library()
    a, w = _scalar(alpha, x.device), _scalar(omega, x.device)
    xo, ro = torch.empty_like(x), torch.empty_like(x)
    part, out = _dot_buffers(lib, x.numel(), 2, x.device)
    code = lib.repro_update_xr_dots(
        _build.dtype_code(x.dtype), a.data_ptr(), w.data_ptr(), x.data_ptr(), p.data_ptr(),
        q.data_ptr(), y.data_ptr(), r0.data_ptr(), xo.data_ptr(), ro.data_ptr(),
        part.data_ptr(), out.data_ptr(), x.numel(), _build.stream_handle(x.device))
    _build.check_launch(lib, code, "update_xr_dots")
    launches["update_xr_dots"] += 1
    return xo, ro, out[0], out[1]


def update_p(beta, omega, r, p, s):
    """p' = r + st(beta)*(p - st(omega)*s)."""
    if not _on_cuda("update_p", r, p, s):
        return ref.update_p_ref(beta, omega, r, p, s)
    lib = _build.load_library()
    b, w = _scalar(beta, r.device), _scalar(omega, r.device)
    po = torch.empty_like(r)
    code = lib.repro_update_p(
        _build.dtype_code(r.dtype), b.data_ptr(), w.data_ptr(), r.data_ptr(), p.data_ptr(),
        s.data_ptr(), po.data_ptr(), r.numel(), _build.stream_handle(r.device))
    _build.check_launch(lib, code, "update_p")
    launches["update_p"] += 1
    return po


def dot_mixed(a, b):
    """<a,b> with products rounded to the storage dtype, summed in f32."""
    if not _on_cuda("dot_mixed", a, b):
        return ref.dot_mixed_ref(a, b)
    lib = _build.load_library()
    part, out = _dot_buffers(lib, a.numel(), 1, a.device)
    code = lib.repro_dot_mixed(
        _build.dtype_code(a.dtype), a.data_ptr(), b.data_ptr(), part.data_ptr(),
        out.data_ptr(), a.numel(), _build.stream_handle(a.device))
    _build.check_launch(lib, code, "dot_mixed")
    launches["dot_mixed"] += 1
    return out[0]
