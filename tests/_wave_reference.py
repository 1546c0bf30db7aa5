"""Plain reference of explicit acoustic wave propagation, for the tests of
``repro_torch.core.wave``.

Written from the equations of the source's workload (Jacquelin, Araya-Polo
and Meng, *Massively scalable stencil algorithm*, SC22: the constant-density
acoustic wave equation, second order in time, 8th-order central differences
in space), in plain PyTorch float32 with no kernel, importing nothing of the
port.  For each point ``i`` with ``c_i = (v_i dt / h)^2``::

    u^{n+1}_i = 2 u^n_i - u^{n-1}_i + c_i * sum_axes [a_0 u^n_i
                + sum_m a_m (u^n_{i+m e} + u^n_{i-m e})]  (+ c_s w(n dt) at s)

with ``u`` zero outside the grid.  The sum is taken as written: axis by axis,
each axis's ``a_0 u`` first and then its pairs, so it rounds in another order
than K7's tap order and agrees with the port to rounding, not bit for bit.

Two controls, each a step below what the workload states: ``storage=bf16``
(the wavefields stored in bfloat16 between steps) and ``radius=2`` (the
4th-order, 13-point Laplacian in place of the 8th-order one).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: second-derivative central-difference weights: radius -> (a_0, (a_1 .. a_r))
FD2 = {
    4: (-205.0 / 72.0, (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)),
    2: (-5.0 / 2.0, (4.0 / 3.0, -1.0 / 12.0)),
}


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def laplacian(u: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """The Laplacian in grid units, zero outside the grid, axis by axis."""
    a0, arms = FD2[radius]
    r = radius
    up = F.pad(u, (r, r) * 3)
    shape = u.shape

    def shifted(axis: int, m: int) -> torch.Tensor:
        return up[tuple(slice(r + (m if a == axis else 0), r + (m if a == axis else 0) + n)
                        for a, n in enumerate(shape))]

    total = None
    for axis in range(3):
        term = a0 * u
        for m, am in enumerate(arms, 1):
            term = term + am * (shifted(axis, m) + shifted(axis, -m))
        total = term if total is None else total + term
    return total


def ricker(steps: int, dt: float, peak_hz: float, delay_s: float) -> list[float]:
    """``w(n dt)`` of a Ricker wavelet, in float64."""
    out = []
    for n in range(steps):
        x = (math.pi * peak_hz * (n * dt - delay_s)) ** 2
        out.append((1.0 - 2.0 * x) * math.exp(-x))
    return out


def shot(c: torch.Tensor, source: tuple[int, int, int], samples: list[float], steps: int, *,
         radius: int = 4, storage: torch.dtype = torch.float32,
         u0: torch.Tensor | None = None, u_prev0: torch.Tensor | None = None) -> torch.Tensor:
    """The final ``u`` of a shot of ``steps`` steps (float32 values), from rest
    unless ``u0``/``u_prev0`` are given; the wavefields are stored in
    ``storage`` between steps."""
    _no_tf32()

    def store(t: torch.Tensor) -> torch.Tensor:
        return t.to(storage).to(torch.float32)

    u = store(u0) if u0 is not None else torch.zeros_like(c)
    w = store(u_prev0) if u_prev0 is not None else torch.zeros_like(c)
    cs = float(c[source])
    for n in range(steps):
        un = 2.0 * u - w + c * laplacian(u, radius)
        un[source] += cs * samples[n]
        w, u = u, store(un)
    return u
