"""Wrappers of the fused BiCGStab passes (CUDA source: ``kernels/csrc/fused_iter.cu``).

Counterparts of ``repro/kernels/fused_iter/kernel.py``: ``update_q_dots_pallas``,
``update_xr_dots_pallas``, ``update_p_pallas`` and ``dot_mixed_pallas``, in
their unbatched forms (flat contiguous vectors, 0-d f32 scalars, 0-d f32 dot
partials) and their batched forms (the ``*_batched`` wrappers: ``(B, n)``
contiguous operands, one launch for all B right-hand sides, ``[B]`` f32
scalars and ``[B]`` f32 dot partials, each RHS's outputs equal to the
unbatched launch on its slice bit for bit).  A CPU tensor takes the plain
version in ``ref.py``, a CUDA tensor launches the kernel or raises.  Scalars
are read by the kernel through a pointer.  ``launches`` counts one per
kernel call (the call's fixed-order partial-sum pass included), CUDA tensors
only, with one counter per form.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_iter import ref

_NAMES = ("update_q_dots", "update_xr_dots", "update_p", "dot_mixed")
#: kernel launches in this process (CUDA tensors only)
launches = {**{n: 0 for n in _NAMES}, **{n + "_batched": 0 for n in _NAMES}}


def _on_cuda(what: str, *vectors: torch.Tensor, ndim: int = 1) -> bool:
    """True for CUDA tensors (after checking them), False for CPU tensors."""
    first = vectors[0]
    if first.device.type == "cpu":
        return False
    if first.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {first.device}")
    _build.dtype_code(first.dtype)
    for t in vectors:
        if (t.device != first.device or t.dtype != first.dtype or t.ndim != ndim
                or t.shape != first.shape or not t.is_contiguous()):
            raise ValueError(
                f"{what} takes contiguous {'(B, n) batches' if ndim == 2 else 'flat vectors'}"
                f" of one shape, dtype and device; got {t.dtype}{tuple(t.shape)} on "
                f"{t.device} vs {first.dtype}{tuple(first.shape)} on {first.device}")
    if first.numel() == 0:
        raise ValueError(f"{what}: empty vectors")
    if ndim == 2 and first.shape[0] > _build.MAX_BATCH:
        raise ValueError(f"{what} takes 1..{_build.MAX_BATCH} right-hand sides, "
                         f"got {first.shape[0]}")
    return True


def _launch(what: str, batched: bool, scalars, vectors, n_out: int, n_dots: int):
    """One pass on checked CUDA operands (B = 1 unbatched): allocate its
    outputs, launch, count; returns (vector outputs, dot sums or None), the
    sums ``(n_dots,)`` unbatched or ``(n_dots, B)`` batched."""
    lib = _build.load_library()
    first = vectors[0]
    nb, n = first.shape if batched else (1, first.numel())
    sc = [torch.as_tensor(x, dtype=torch.float32, device=first.device).reshape(nb).contiguous()
          for x in scalars]
    outs = [torch.empty_like(first) for _ in range(n_out)]
    bufs = []
    if n_dots:
        blocks = getattr(lib, f"repro_{what}_blocks")(n)   # each pass sizes its own grid
        bufs = [torch.empty(nb * blocks * n_dots, dtype=torch.float32, device=first.device),
                torch.empty((n_dots, nb) if batched else (n_dots,), dtype=torch.float32,
                            device=first.device)]
    code = getattr(lib, "repro_" + what)(
        _build.dtype_code(first.dtype), *(t.data_ptr() for t in (*sc, *vectors, *outs, *bufs)),
        n, nb, _build.stream_handle(first.device))
    name = what + "_batched" if batched else what
    _build.check_launch(lib, code, name)
    launches[name] += 1
    return outs, bufs[1] if n_dots else None


def update_q_dots(alpha, r, s, y):
    """(q, <q,y>, <y,y>) with q = r - st(alpha)*s."""
    if not _on_cuda("update_q_dots", r, s, y):
        return ref.update_q_dots_ref(alpha, r, s, y)
    (q,), d = _launch("update_q_dots", False, (alpha,), (r, s, y), 1, 2)
    return q, d[0], d[1]


def update_xr_dots(alpha, omega, x, p, q, y, r0):
    """(x', r', <r0,r'>, <r',r'>) with x' = x + st(alpha)*p + st(omega)*q,
    r' = q - st(omega)*y."""
    if not _on_cuda("update_xr_dots", x, p, q, y, r0):
        return ref.update_xr_dots_ref(alpha, omega, x, p, q, y, r0)
    (xo, ro), d = _launch("update_xr_dots", False, (alpha, omega), (x, p, q, y, r0), 2, 2)
    return xo, ro, d[0], d[1]


def update_p(beta, omega, r, p, s):
    """p' = r + st(beta)*(p - st(omega)*s)."""
    if not _on_cuda("update_p", r, p, s):
        return ref.update_p_ref(beta, omega, r, p, s)
    return _launch("update_p", False, (beta, omega), (r, p, s), 1, 0)[0][0]


def dot_mixed(a, b):
    """<a,b> with products rounded to the storage dtype, summed in f32."""
    if not _on_cuda("dot_mixed", a, b):
        return ref.dot_mixed_ref(a, b)
    return _launch("dot_mixed", False, (), (a, b), 0, 1)[1][0]


# --- batched forms: (B, n) operands, [B] scalars and dots --------------------

def update_q_dots_batched(alpha, r, s, y):
    """Per RHS b: (q[b], <q,y>[b], <y,y>[b]) with q[b] = r[b] - st(alpha[b])*s[b]."""
    if not _on_cuda("update_q_dots_batched", r, s, y, ndim=2):
        return ref.update_q_dots_batched_ref(alpha, r, s, y)
    (q,), d = _launch("update_q_dots", True, (alpha,), (r, s, y), 1, 2)
    return q, d[0], d[1]


def update_xr_dots_batched(alpha, omega, x, p, q, y, r0):
    """:func:`update_xr_dots` per RHS, with ``[B]`` alpha and omega."""
    if not _on_cuda("update_xr_dots_batched", x, p, q, y, r0, ndim=2):
        return ref.update_xr_dots_batched_ref(alpha, omega, x, p, q, y, r0)
    (xo, ro), d = _launch("update_xr_dots", True, (alpha, omega), (x, p, q, y, r0), 2, 2)
    return xo, ro, d[0], d[1]


def update_p_batched(beta, omega, r, p, s):
    """:func:`update_p` per RHS, with ``[B]`` beta and omega."""
    if not _on_cuda("update_p_batched", r, p, s, ndim=2):
        return ref.update_p_batched_ref(beta, omega, r, p, s)
    return _launch("update_p", True, (beta, omega), (r, p, s), 1, 0)[0][0]


def dot_mixed_batched(a, b):
    """``[B]`` of <a[b], b[b]>, products rounded to storage, summed in f32."""
    if not _on_cuda("dot_mixed_batched", a, b, ndim=2):
        return ref.dot_mixed_batched_ref(a, b)
    return _launch("dot_mixed", True, (), (a, b), 0, 1)[1][0]
