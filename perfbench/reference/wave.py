"""Plain reference of explicit acoustic wave propagation: the source's
workload (Jacquelin, Araya-Polo and Meng, SC22), written from its equations.

For each point ``i`` with ``c_i = (v_i dt / h)^2``::

    u^{n+1}_i = 2 u^n_i - u^{n-1}_i + c_i * sum_axes [a_0 u^n_i
                + sum_m a_m (u^n_{i+m e} + u^n_{i-m e})]  (+ c_s w(n dt) at s)

with ``u`` zero outside the grid, the weights of
``reference/operators/acoustic_fd8.py``, and the sum taken as written: axis
by axis, each axis's ``a_0 u`` first and then its pairs.  Plain PyTorch in
float32, no kernel, nothing of the program; TF32 is off (no product here
uses it, and none may).

So that its temporaries stay within a few GB on the card, a step works in
x-slabs, each reading its planes of ``u`` with 4-plane halos, and writes
``u^{n+1}`` over ``u^{n-1}`` slab by slab (a slab reads ``u^{n-1}`` only at
its own points).  A shot from rest steps only the box where ``u^{n+1}`` can
be nonzero: the bounding box of the nonzero points of ``u^n`` and
``u^{n-1}`` and the source, grown by the radius.  Outside it ``u^n``,
``u^{n-1}`` and the Laplacian of ``u^n`` are all 0, so ``u^{n+1}`` is 0
there exactly and the box changes no value; in 200 steps the wave and its
numerical precursor reach some tens of points, so the box is a small part
of the grid.

Controls, each a step below what the workload states: ``storage=bf16`` (the
wavefields stored in bfloat16 between steps) and ``radius=2`` (the 4th-order,
13-point Laplacian in place of the 8th-order one).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.operators.acoustic_fd8 import weights

#: points per x-slab (each temporary of a slab is at most this many floats)
SLAB_POINTS = 1 << 25

Box = tuple[tuple[int, int], tuple[int, int], tuple[int, int]]


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def ricker(steps: int, dt: float, peak_hz: float, delay_s: float) -> list[float]:
    """``w(n dt)`` of a Ricker wavelet, ``(1 - 2x) exp(-x)`` with ``x = (pi f
    (t - t0))^2``, in float64."""
    out = []
    for n in range(steps):
        x = (math.pi * peak_hz * (n * dt - delay_s)) ** 2
        out.append((1.0 - 2.0 * x) * math.exp(-x))
    return out


def _laplacian(up: torch.Tensor, shape, radius: int) -> torch.Tensor:
    """The Laplacian of the interior of ``up`` (padded by ``radius`` on every
    side), axis by axis as the equation is written."""
    a0, arms = weights(radius)
    r = radius

    def shifted(axis: int, m: int) -> torch.Tensor:
        return up[tuple(slice(r + (m if a == axis else 0), r + (m if a == axis else 0) + n)
                        for a, n in enumerate(shape))]

    total = None
    for axis in range(3):
        term = a0 * shifted(0, 0)
        for m, am in enumerate(arms, 1):
            term = term + am * (shifted(axis, m) + shifted(axis, -m))
        total = term if total is None else total + term
    return total


def step_into(u: torch.Tensor, w: torch.Tensor, c: torch.Tensor, box: Box, *,
              radius: int = 4, source=None, term: float = 0.0,
              storage: torch.dtype = torch.float32) -> None:
    """``u^{n+1}`` over ``w`` (``u^{n-1}``) inside ``box``, slab by slab;
    ``term`` (``c_s w(n dt)``) added at ``source`` when it lies in the box.
    Values are stored in ``storage``'s precision."""
    _no_tf32()
    r = radius
    (x0, x1), (y0, y1), (z0, z1) = box
    nxg, nyg, nzg = u.shape
    step = max(1, SLAB_POINTS // max(1, (y1 - y0) * (z1 - z0)))
    for xa in range(x0, x1, step):
        xb = min(x1, xa + step)
        lo = [xa - r, y0 - r, z0 - r]
        hi = [xb + r, y1 + r, z1 + r]
        cut = tuple(slice(max(a, 0), min(b, n)) for a, b, n in zip(lo, hi, (nxg, nyg, nzg)))
        pads = []
        for a, b, n in reversed(list(zip(lo, hi, (nxg, nyg, nzg)))):
            pads += [max(0, -a), max(0, b - n)]
        up = F.pad(u[cut], pads)
        shape = (xb - xa, y1 - y0, z1 - z0)
        region = (slice(xa, xb), slice(y0, y1), slice(z0, z1))
        un = 2.0 * u[region] - w[region] + c[region] * _laplacian(up, shape, r)
        del up
        if source is not None and all(a <= s < b for s, (a, b) in
                                      zip(source, ((xa, xb), (y0, y1), (z0, z1)))):
            un[source[0] - xa, source[1] - y0, source[2] - z0] += term
        w[region] = un.to(storage).to(torch.float32)


def _support(t: torch.Tensor, box: Box) -> Box | None:
    """The bounding box of the nonzero points of ``t`` inside ``box``."""
    region = tuple(slice(a, b) for a, b in box)
    nz = t[region] != 0
    out = []
    for axis in range(3):
        idx = torch.nonzero(nz.any(dim=[a for a in range(3) if a != axis])).flatten()
        if idx.numel() == 0:
            return None
        out.append((box[axis][0] + int(idx[0]), box[axis][0] + int(idx[-1]) + 1))
    return tuple(out)


def _grow(boxes, radius: int, shape) -> Box:
    """The union of ``boxes`` grown by ``radius``, clipped to the grid."""
    boxes = [b for b in boxes if b is not None]
    return tuple((max(0, min(b[a][0] for b in boxes) - radius),
                  min(n, max(b[a][1] for b in boxes) + radius))
                 for a, n in enumerate(shape))


def shot(c: torch.Tensor, source: tuple[int, int, int], samples: list[float], steps: int, *,
         radius: int = 4, storage: torch.dtype = torch.float32) -> torch.Tensor:
    """The final ``u`` of a shot of ``steps`` steps from rest, the wavefields
    stored in ``storage`` between steps; each step works in the box where its
    result can be nonzero (see above)."""
    u = torch.zeros_like(c)
    w = torch.zeros_like(c)
    cs = float(c[source])
    point = tuple((s, s + 1) for s in source)
    sup_u = sup_w = None
    for n in range(steps):
        box = _grow([sup_u, sup_w, point], radius, c.shape)
        step_into(u, w, c, box, radius=radius, source=source, term=cs * samples[n],
                  storage=storage)
        sup_u, sup_w = _support(w, box), sup_u
        u, w = w, u
    return u


def one_step(u: torch.Tensor, w: torch.Tensor, c: torch.Tensor, source, term: float, *,
             radius: int = 4, storage: torch.dtype = torch.float32) -> torch.Tensor:
    """``u^{n+1}`` of one step on the whole grid from ``u`` and ``w`` (neither
    is written), the wavefields stored in ``storage``."""
    u = u.to(storage).to(torch.float32)
    out = w.to(storage).to(torch.float32).clone()
    whole = tuple((0, n) for n in c.shape)
    step_into(u, out, c, whole, radius=radius, source=source, term=term, storage=storage)
    return out
