"""The 7-point upwinded convection-diffusion operator of the paper's
experiment (Rocki et al., SC20, §V: the MFIX-class momentum system),
Jacobi-normalised.

Per axis with velocity ``u_a`` at cell Peclet number ``Pe``: diffusion
couples each face by -1, and first-order upwinding adds ``-Pe * u_a`` to the
upstream (``-``) neighbour.  The diagonal before normalisation is the sum
``2 + Pe * u_a`` over the axes, and every coupling is divided by it.  The
value is the same at every point; each is stored per point, as the paper's
processing elements hold their own coefficients.
"""

from __future__ import annotations

import torch

from perfbench.reference.stencil import star_offsets


def offsets(params: dict):
    return star_offsets(1)


def fields(shape, params: dict, device) -> dict[str, torch.Tensor]:
    pe = float(params["peclet"])
    vel = [float(u) for u in params["velocity"]]
    diag = sum(2.0 + pe * u for u in vel)
    raw = {}
    for ax, u in enumerate(vel):
        plus, minus = star_offsets(1)[2 * ax][0], star_offsets(1)[2 * ax + 1][0]
        raw[plus] = -1.0
        raw[minus] = -1.0 - pe * u
    return {name: torch.full(tuple(shape), raw[name] / diag, dtype=torch.float32,
                             device=device)
            for name, _ in offsets(params)}
