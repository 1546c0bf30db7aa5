"""The constant-density acoustic wave operator of the source's workload
(Jacquelin, Araya-Polo and Meng, SC22: Minimod's isotropic acoustic kernel),
and the medium of its cell.

The Laplacian is 8th-order central differences in grid units, a 25-point
star of radius 4 whose weights are the same at every point: ``a_0 .. a_4`` =
-205/72, 8/5, -1/5, 8/315, -1/560 along each axis (the 4th-order control's
are -5/2, 4/3, -1/12).  One model field a point, ``c = (v dt / h)^2``.

The medium (``velocity``): ``v_top`` to ``v_bottom`` m/s linearly with
depth along Z (the contiguous axis), times ``1 + lateral p(x, y)`` with
``p`` a smooth field of ``|p| <= 1``: a sum of cosines of at most two periods
across X and Y, amplitudes and phases drawn from the seed.

Unlike the Krylov operators' modules it has no ``fields``: the taps' weights
are the same at every point (``weights``), and ``c`` is formed from the
medium (``velocity``, ``c_of``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: second-derivative weights: radius -> (a_0, (a_1 .. a_r))
FD2 = {
    4: (-205.0 / 72.0, (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)),
    2: (-5.0 / 2.0, (4.0 / 3.0, -1.0 / 12.0)),
}


def weights(radius: int) -> tuple[float, tuple[float, ...]]:
    return FD2[radius]


def velocity(shape, params: dict, seed: int, device) -> torch.Tensor:
    """The cell's velocity model in m/s, float32, made on ``device``."""
    nx, ny, nz = (int(s) for s in shape)
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 0x5E15]))
    amp = rng.random(9)
    phase = 2.0 * math.pi * rng.random(9)
    x = torch.arange(nx, dtype=torch.float64, device=device)[:, None] / nx
    y = torch.arange(ny, dtype=torch.float64, device=device)[None, :] / ny
    p = torch.zeros((nx, ny), dtype=torch.float64, device=device)
    for k in range(9):
        p += float(amp[k]) * torch.cos(2.0 * math.pi * ((k // 3) * x + (k % 3) * y)
                                       + float(phase[k]))
    p /= float(amp.sum())
    depth = torch.arange(nz, dtype=torch.float64, device=device) / max(nz - 1, 1)
    top, bottom = float(params["v_top_m_s"]), float(params["v_bottom_m_s"])
    profile = (top + (bottom - top) * depth).to(torch.float32)
    lateral = (1.0 + float(params["lateral"]) * p).to(torch.float32)
    return profile[None, None, :] * lateral[:, :, None]


def c_of(v: torch.Tensor, params: dict) -> torch.Tensor:
    """``c = (v dt / h)^2``, formed in float64 and rounded to float32, plane by
    plane so that no float64 copy of the whole medium is held."""
    k = float(params["dt_s"]) / float(params["h_m"])
    out = torch.empty_like(v, dtype=torch.float32)
    for i in range(v.shape[0]):
        out[i] = ((v[i].double() * k) ** 2).float()
    return out
