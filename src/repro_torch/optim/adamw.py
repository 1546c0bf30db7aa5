"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule.

The port of ``repro/optim/adamw.py``.  Moments are kept in f32 whatever the
parameter dtype; the update is computed in f32 and cast back to the
parameter's dtype.  Parameters, gradients and moments are trees of tensors
(nested dicts, the reference's stacked layout), walked in
``jax.tree.leaves`` order (dict keys sorted) wherever the order matters:
the global norm sums its leaves in that order.

Every expression keeps the reference's operations and their order, one
rounding each (no fused multiply-add: separate ``mul`` and ``add``, never
``add(..., alpha=)``, whose CPU kernel fuses).  XLA on the CPU contracts
``a * b + c`` into FMAs, so the two packages agree to about 2 ulps of each
expression's largest term, not bit for bit.  Every division divides by a
tensor on the dividend's device (:func:`div`): PyTorch computes
``scalar / t`` as a reciprocal times the scalar, and on the card
``t / scalar`` as ``t`` times the scalar's reciprocal, each one more
rounding than the reference's division.

The update runs leaf by leaf, and a large leaf in chunks of ``CHUNK``
elements (the arithmetic is element-wise, so the chunking changes no bit),
so its f32 temporaries stay small beside the moments.  It is functional:
the tensors it is given are not written, and the caller (the runner, which
restores from its initial state when no checkpoint exists) may keep them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.param import map_tree, map_trees, tree_leaves

F32 = torch.float32
#: elements a leaf's update handles at once (f32 temporaries of 256 MB each)
CHUNK = 1 << 26


@dataclasses.dataclass
class AdamWState:
    mu: dict
    nu: dict
    count: torch.Tensor     # int32 scalar on the parameters' device


def adamw_init(params) -> AdamWState:
    f32 = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    dev = tree_leaves(params)[0][1].device
    return AdamWState(mu=map_tree(f32, params), nu=map_tree(f32, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def div(a, b) -> torch.Tensor:
    """``a / b`` rounded once, with ``a`` or ``b`` a Python number: the
    number becomes an f32 tensor on the other's device first."""
    dev = (a if isinstance(a, torch.Tensor) else b).device
    f = lambda x: x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=F32, device=dev)
    return torch.div(f(a), f(b))


def cosine_lr(step, *, peak: float = 3e-4, warmup: int = 100, total: int = 10000,
              floor: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), as an f32
    scalar tensor on ``step``'s device."""
    step = (step.to(F32) if isinstance(step, torch.Tensor)
            else torch.tensor(step, dtype=F32))
    warm = div(peak * (step + 1), max(warmup, 1))   # step 0 takes a real (small) step
    frac = torch.clamp(div(step - warmup, max(total - warmup, 1)), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for _, g in tree_leaves(tree)))


def _update_leaf(p, g, m, n, *, scale, lr, c1, c2, b1, b2, eps, weight_decay):
    """One leaf's new (parameter, mu, nu), computed in chunks."""
    p_new, m_new, n_new = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                           for t in (p, m, n))
    flat = [t.contiguous().reshape(-1) for t in (p, g, m, n, p_new, m_new, n_new)]
    fp, fg, fm, fn, op, om, on = flat
    for lo in range(0, fp.numel(), CHUNK):
        sl = slice(lo, lo + CHUNK)
        gc = fg[sl].to(F32)
        if scale is not None:
            gc = gc * scale
        mc = b1 * fm[sl] + (1 - b1) * gc
        nc = b2 * fn[sl] + (1 - b2) * gc * gc
        st = (mc / c1) / (torch.sqrt(nc / c2) + eps)
        pf = fp[sl].to(F32)
        st = st + weight_decay * pf
        op[sl] = (pf - lr * st).to(p.dtype)
        om[sl] = mc
        on[sl] = nc
    return p_new, m_new, n_new


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float | None = 1.0, grad_norm: torch.Tensor | None = None):
    """Returns (new params, new state); the inputs are left as they were.
    ``grad_norm``: the global norm to clip by, when ``grads`` are blocks of
    the full gradients (the sharded step); by default ``global_norm(grads)``."""
    count = state.count + 1
    scale = None
    if clip_norm is not None:
        gn = global_norm(grads) if grad_norm is None else grad_norm
        scale = torch.clamp(div(clip_norm, torch.clamp(gn, min=1e-9)), max=1.0)
    cf = count.to(F32)
    c1 = 1 - b1 ** cf
    c2 = 1 - b2 ** cf
    out = map_trees(
        lambda p, g, m, n: _update_leaf(p, g, m, n, scale=scale, lr=lr, c1=c1, c2=c2, b1=b1,
                                        b2=b2, eps=eps, weight_decay=weight_decay),
        params, grads, state.mu, state.nu)
    pick = lambda i: map_trees(lambda _, new: new[i], params, out)
    return pick(0), AdamWState(pick(1), pick(2), count)
