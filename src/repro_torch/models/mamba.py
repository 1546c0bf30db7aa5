"""Mamba (S6 selective SSM) block for Jamba's hybrid layers (arXiv:2312.00752,
Jamba arXiv:2403.19887).

The port of ``repro/models/mamba.py``:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t        (diag A, per channel)
    y_t = C_t . h_t + D x_t

Prefill evaluates the diagonal linear recurrence with an associative scan
over time; decode keeps O(1) state.  The scan is :func:`_associative_scan`,
``jax.lax.associative_scan``'s recursion step for step (combine adjacent
pairs, scan the half-length result, combine the even elements, interleave),
so each output is the same product and sum tree as the reference's: about
2 log2(T) tensor operations over (B, T/2^i, d_inner, N) slices, not a loop
over T.  XLA on the CPU contracts the combine's ``a2 * b1 + b2`` into one
FMA and torch does not, so the two agree to a few f32 ulps.

``softplus`` is ``jax.nn.softplus``'s ``logaddexp(x, 0)`` (torch's
``softplus`` returns x above a threshold of 20).  No kernel: the
reference's scan is computed by XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import F32, silu
from repro_torch.models.param import ParamDef


def build_params(d_model: int, *, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: int | None = None,
                 dtype=torch.bfloat16) -> dict:
    d_inner = expand * d_model
    dt_rank = dt_rank or math.ceil(d_model / 16)
    return {
        "in_proj": ParamDef((d_model, 2 * d_inner), ("d_model", "heads_flat"), dtype=dtype),
        "conv_w": ParamDef((d_conv, d_inner), ("conv", "heads_flat"), dtype=dtype),
        "conv_b": ParamDef((d_inner,), ("heads_flat",), init="zeros", dtype=dtype),
        "x_proj": ParamDef((d_inner, dt_rank + 2 * d_state), ("heads_flat", None), dtype=dtype),
        "dt_w": ParamDef((dt_rank, d_inner), (None, "heads_flat"), dtype=dtype),
        "dt_b": ParamDef((d_inner,), ("heads_flat",), init="ones", dtype=F32),
        "A_log": ParamDef((d_inner, d_state), ("heads_flat", "state"), init="ones", dtype=F32),
        "D": ParamDef((d_inner,), ("heads_flat",), init="ones", dtype=F32),
        "out_proj": ParamDef((d_inner, d_model), ("heads_flat", "d_model"), dtype=dtype),
        "norm_w": ParamDef((d_inner,), ("heads_flat",), init="ones", dtype=F32),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_inputs(p, x: torch.Tensor):
    """Shared front half: the input projection, split into the SSM input and the gate."""
    xz = x @ p.in_proj
    xs, z = torch.chunk(xz, 2, dim=-1)
    return xs, z


def _discretize(p, xs: torch.Tensor):
    d_state = p.A_log.shape[1]
    dt_rank = p.dt_w.shape[0]
    proj = xs @ p.x_proj                                        # (B,T,R+2N)
    dt_in, Bc, Cc = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = softplus(torch.einsum("btr,rd->btd", dt_in.to(F32), p.dt_w.to(F32))
                  + p.dt_b)                                     # (B,T,d_in) f32
    A = -torch.exp(p.A_log)                                     # (d_in, N) f32
    da = torch.exp(dt[..., None] * A[None, None])               # (B,T,d_in,N)
    db = dt[..., None] * Bc[:, :, None, :].to(F32)              # (B,T,d_in,N)
    return da, db, Cc, dt


def _causal_conv(p, xs: torch.Tensor, conv_state=None):
    """Depthwise causal conv1d (k=d_conv). conv_state: (B, k-1, d_inner).
    The new state is the last k-1 inputs before the activation."""
    k = p.conv_w.shape[0]
    T = xs.shape[1]
    if conv_state is None:
        conv_state = torch.zeros((xs.shape[0], k - 1, xs.shape[-1]), dtype=xs.dtype,
                                 device=xs.device)
    xpad = torch.cat([conv_state.to(xs.dtype), xs], dim=1)
    out = sum(xpad[:, i:i + T] * p.conv_w[i][None, None] for i in range(k)) + p.conv_b
    new_state = xpad[:, -(k - 1):]
    return silu(out.to(F32)).to(xs.dtype), new_state


def _combine(a, b):
    """Linear recurrence h' = a2*(a1*h + b1) + b2: the composition of two steps."""
    a1, b1 = a
    a2, b2 = b
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 1: even[0], odd[0], even[1], odd[1], ..."""
    n = even.shape[1] + odd.shape[1]
    out = torch.empty((even.shape[0], n) + even.shape[2:], dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor, with_a: bool = True):
    """Inclusive scan of :func:`_combine` over axis 1, in the order of
    ``jax.lax.associative_scan`` (``jax/_src/lax/control_flow/loops.py``).
    ``with_a=False`` leaves out the scanned ``a`` of the outermost level
    (returned as None), which no caller of the whole scan reads."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, then scan the half-length result
    odd_a, odd_b = _associative_scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                               (a[:, 1::2], b[:, 1::2])))
    lo = (odd_a[:, :-1], odd_b[:, :-1]) if n % 2 == 0 else (odd_a, odd_b)
    ev_a, ev_b = _combine(lo, (a[:, 2::2], b[:, 2::2]))
    # the first element of a scan is the first input
    ev_b = _interleave(torch.cat([b[:, :1], ev_b], dim=1), odd_b)
    if not with_a:
        return None, ev_b
    return _interleave(torch.cat([a[:, :1], ev_a], dim=1), odd_a), ev_b


def _gate_norm_out(p, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor, dtype):
    """y + D x, gated by silu(z), Jamba's RMSNorm, then the out-projection."""
    y = y + p.D * xs.to(F32)
    y = y * silu(z.to(F32))
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6) * p.norm_w).to(dtype)
    return y @ p.out_proj


def mamba_apply(p, x: torch.Tensor, *, state=None, conv_state=None):
    """Full sequence (prefill) via the associative scan.

    Returns (out, (ssm_state (B,d_in,N) f32, conv_state (B,k-1,d_in)))."""
    xs, z = _ssm_inputs(p, x)
    xs, conv_state = _causal_conv(p, xs, conv_state)
    da, db, Cc, dt = _discretize(p, xs)
    bx = db * xs.to(F32)[..., None]                             # (B,T,d_in,N)
    del db
    if state is not None:
        # fold the carried state into the first step: h_0' contribution
        bx[:, 0] += da[:, 0] * state
    _, h = _associative_scan(da, bx, with_a=False)
    del da, bx
    y = torch.einsum("btdn,btn->btd", h, Cc.to(F32))
    out = _gate_norm_out(p, y, xs, z, x.dtype)
    return out, (h[:, -1], conv_state)


def mamba_decode(p, x: torch.Tensor, state: torch.Tensor, conv_state: torch.Tensor):
    """One-token step, O(1) state. x: (B, 1, d)."""
    xs, z = _ssm_inputs(p, x)
    xs, conv_state = _causal_conv(p, xs, conv_state)
    da, db, Cc, dt = _discretize(p, xs)
    h = da[:, 0] * state + db[:, 0] * xs.to(F32)[:, 0, :, None]
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0].to(F32))
    out = _gate_norm_out(p, y[:, None], xs, z, x.dtype)
    return out, (h, conv_state)
