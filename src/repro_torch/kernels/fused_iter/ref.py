"""Plain PyTorch versions of the fused BiCGStab passes.

They follow the TPU kernel bodies of ``repro/kernels/fused_iter/kernel.py``
op for op: vector updates in the storage dtype with the f32 scalars rounded
to storage first, fused dots from the f32-upcast values, and ``dot_mixed``
rounding each product to storage before the f32 sum.  The batched forms
apply the unbatched plain version to each RHS slice of a ``(B, n)`` operand
with that RHS's scalars and stack the results, so every RHS is computed as a
lone vector would be.  The kernel wrappers run these on CPU tensors; the
card checks compare the CUDA kernels against them (vectors bitwise, dots to
a summation-order tolerance).
"""

from __future__ import annotations

import torch


def _st(scalar, like: torch.Tensor) -> torch.Tensor:
    """An f32 scalar rounded to ``like``'s storage dtype (the kernel's
    ``alpha.astype(storage)`` of an f32 scalar operand)."""
    return torch.as_tensor(scalar, device=like.device).to(torch.float32).to(like.dtype)


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.float32) * b.to(torch.float32)).sum()


def update_q_dots_ref(alpha, r, s, y):
    """q = r - st(alpha)*s; f32 <q,y>, <y,y>."""
    q = r - _st(alpha, r) * s
    return q, _dot_f32(q, y), _dot_f32(y, y)


def update_xr_dots_ref(alpha, omega, x, p, q, y, r0):
    """x' = x + st(alpha)*p + st(omega)*q, r' = q - st(omega)*y; f32 <r0,r'>, <r',r'>."""
    a, w = _st(alpha, x), _st(omega, x)
    x_new = x + a * p + w * q
    r_new = q - w * y
    return x_new, r_new, _dot_f32(r0, r_new), _dot_f32(r_new, r_new)


def update_p_ref(beta, omega, r, p, s):
    """p' = r + st(beta)*(p - st(omega)*s)."""
    b, w = _st(beta, p), _st(omega, p)
    return r + b * (p - w * s)


def dot_mixed_ref(a, b):
    """<a,b> with each product rounded to the storage dtype, summed in f32."""
    return (a * b).to(torch.float32).sum()


def _per_rhs(fn, scalars, vectors):
    """``fn`` on each RHS slice with its own scalars, outputs stacked."""
    nb = vectors[0].shape[0]
    sc = [torch.as_tensor(a).reshape(nb) for a in scalars]
    outs = [fn(*(a[i] for a in sc), *(v[i] for v in vectors)) for i in range(nb)]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


def update_q_dots_batched_ref(alpha, r, s, y):
    return _per_rhs(update_q_dots_ref, (alpha,), (r, s, y))


def update_xr_dots_batched_ref(alpha, omega, x, p, q, y, r0):
    return _per_rhs(update_xr_dots_ref, (alpha, omega), (x, p, q, y, r0))


def update_p_batched_ref(beta, omega, r, p, s):
    return _per_rhs(update_p_ref, (beta, omega), (r, p, s))


def dot_mixed_batched_ref(a, b):
    return _per_rhs(dot_mixed_ref, (), (a, b))
