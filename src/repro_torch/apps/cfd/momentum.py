"""Momentum-system formation (paper §VI Alg. 2, the "forming" half of
Table II): first-order upwind convection + central diffusion on the
staggered MAC grid, with Patankar in-equation under-relaxation.

Counterpart of ``repro/apps/cfd/momentum.py``, op for op.  All formation
arithmetic runs in float32 regardless of the solver policy: the ``aP`` clamp
and every division (off-diagonal normalization, the SIMPLE ``d``
coefficient) happen *before* the cast to ``policy.storage`` — clamping in a
16-bit storage dtype can flush a tiny diagonal to zero and poison the whole
pressure correction.

Inputs are halo-padded local blocks (``gather_halo(..., corners=True)`` —
the cross-velocity face averages read diagonal neighbors), plus global index
grids for boundary masks, so the same code forms the local rows of the
global matrix on any block of a fabric.
"""

from __future__ import annotations

import torch

from repro_torch.apps.cfd.grid import CFDConfig

#: storage-dtype-independent clamp floor for the momentum/continuity diagonal
AP_FLOOR = 1e-12


def divide(a, b) -> torch.Tensor:
    """``a / b`` rounded once, either side possibly a Python number.

    Torch computes ``number / tensor`` as a reciprocal times the number, and
    on CUDA divides by a Python number through its reciprocal: two roundings
    where the reference rounds once.  A 0-d tensor on the operand's device
    keeps the true division on every device."""
    like = b if isinstance(b, torch.Tensor) else a
    as_t = lambda x: x if isinstance(x, torch.Tensor) else torch.tensor(
        x, dtype=like.dtype, device=like.device)
    return torch.div(as_t(a), as_t(b))


def window(padded: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """Block-shaped window of a radius-1 halo-padded block, shifted (di, dj)."""
    bx, by = padded.shape[0] - 2, padded.shape[1] - 2
    return padded[1 + di:1 + di + bx, 1 + dj:1 + dj + by]


def upwind_coeffs(Fe, Fw, Fn, Fs, D):
    """First-order upwind + central diffusion link coefficients."""
    aE = D + torch.clamp_min(-Fe, 0.0)
    aW = D + torch.clamp_min(Fw, 0.0)
    aN = D + torch.clamp_min(-Fn, 0.0)
    aS = D + torch.clamp_min(Fs, 0.0)
    aP = aE + aW + aN + aS + (Fe - Fw) + (Fn - Fs)
    return aP, aE, aW, aN, aS


def _relax_and_d(cfg: CFDConfig, aP, b, x_now, x_t, h):
    """Transient term, Patankar relaxation, diagonal clamp, SIMPLE ``d``.

    Clamp and division happen here, in f32 — before any storage cast.
    """
    if cfg.dt is not None:
        at = h * h / cfg.dt
        aP = aP + at
        b = b + at * x_t
    aP = divide(aP, cfg.alpha_u)
    b = b + (1.0 - cfg.alpha_u) * aP * x_now
    aP = torch.clamp_min(aP, AP_FLOOR)
    d = divide(h, aP)
    return aP, b, d


def form_u_system(cfg: CFDConfig, up, vp, pp, u, u_t, gi, gj):
    """u-momentum rows for every stored east face.

    ``up``/``vp``/``pp`` are halo-padded f32 blocks of the OLD fields (both
    momentum systems form from the same time/outer level, as in Alg. 2);
    ``u`` is the unpadded current block (relaxation anchor), ``u_t`` the
    previous time level.  Returns ``(aP, aE, aW, aN, aS, b, du)`` with
    boundary rows already folded in.
    """
    n = cfg.n
    h = 1.0 / n
    D = 1.0 / cfg.reynolds           # mu; rho = U = L = 1
    channel = cfg.scenario == "channel"

    # face fluxes seen by the u-control-volume around east face (gi, gj)
    Fe = 0.5 * h * (window(up, 0, 0) + window(up, 1, 0))
    Fw = 0.5 * h * (window(up, -1, 0) + window(up, 0, 0))
    Fn = 0.5 * h * (window(vp, 0, 0) + window(vp, 1, 0))
    Fs = 0.5 * h * (window(vp, 0, -1) + window(vp, 1, -1))
    if channel:
        # inlet face carries u_in, not the zero the wall halo provided
        Fw = torch.where(gi == 0, Fw + 0.5 * h * cfg.u_in, Fw)
    aP, aE, aW, aN, aS = upwind_coeffs(Fe, Fw, Fn, Fs, D)

    b = (window(pp, 0, 0) - window(pp, 1, 0)) * h
    # no-slip top/bottom: wall shear via half-cell diffusion; lid adds source
    lid = cfg.lid_velocity if cfg.scenario == "cavity" else 0.0
    aP = aP + torch.where((gj == 0) | (gj == n - 1), 2.0 * D, 0.0)
    b = b + torch.where(gj == n - 1, 2.0 * D * lid, 0.0)
    aN = torch.where(gj == n - 1, 0.0, aN)
    aS = torch.where(gj == 0, 0.0, aS)
    if channel:
        # inlet: the west neighbor is the known boundary face u_in
        b = b + torch.where(gi == 0, aW * cfg.u_in, 0.0)
        aW = torch.where(gi == 0, 0.0, aW)

    aP, b, du = _relax_and_d(cfg, aP, b, u, u_t, h)

    # last stored face: right wall (cavity, value 0) or zero-gradient outlet
    last = gi == n - 1
    aP = torch.where(last, 1.0, aP)
    aE = torch.where(last, 0.0, aE)
    aW = torch.where(last, 1.0 if channel else 0.0, aW)
    aN = torch.where(last, 0.0, aN)
    aS = torch.where(last, 0.0, aS)
    b = torch.where(last, 0.0, b)
    du = torch.where(last, 0.0, du)
    return aP, aE, aW, aN, aS, b, du


def form_v_system(cfg: CFDConfig, up, vp, pp, v, v_t, gi, gj):
    """v-momentum rows for every stored north face (mirror of the u system)."""
    n = cfg.n
    h = 1.0 / n
    D = 1.0 / cfg.reynolds
    channel = cfg.scenario == "channel"

    Fn = 0.5 * h * (window(vp, 0, 0) + window(vp, 0, 1))
    Fs = 0.5 * h * (window(vp, 0, -1) + window(vp, 0, 0))
    Fe = 0.5 * h * (window(up, 0, 0) + window(up, 0, 1))
    Fw = 0.5 * h * (window(up, -1, 0) + window(up, -1, 1))
    if channel:
        Fw = torch.where(gi == 0, Fw + h * cfg.u_in, Fw)  # both corner faces = u_in
    aP, aE, aW, aN, aS = upwind_coeffs(Fe, Fw, Fn, Fs, D)

    b = (window(pp, 0, 0) - window(pp, 0, 1)) * h
    # no-slip left/right walls (cavity); channel: inlet is a v=0 Dirichlet
    # face (same half-cell fold), outlet is zero-gradient (no fold, aE open)
    wall_lo = gi == 0
    wall_hi = gi == n - 1
    aP = aP + torch.where(wall_lo, 2.0 * D, 0.0)
    if channel:
        aE = torch.where(wall_hi, 0.0, aE)        # zero-gradient outlet
    else:
        aP = aP + torch.where(wall_hi, 2.0 * D, 0.0)
        aE = torch.where(wall_hi, 0.0, aE)
    aW = torch.where(wall_lo, 0.0, aW)

    aP, b, dv = _relax_and_d(cfg, aP, b, v, v_t, h)

    # last stored face: the top wall (v = 0) in both scenarios
    last = gj == n - 1
    aP = torch.where(last, 1.0, aP)
    aE = torch.where(last, 0.0, aE)
    aW = torch.where(last, 0.0, aW)
    aN = torch.where(last, 0.0, aN)
    aS = torch.where(last, 0.0, aS)
    b = torch.where(last, 0.0, b)
    dv = torch.where(last, 0.0, dv)
    return aP, aE, aW, aN, aS, b, dv
