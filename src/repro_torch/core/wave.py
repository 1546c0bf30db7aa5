"""Explicit acoustic wave propagation: the source workload of the 25-point star.

Jacquelin, Araya-Polo and Meng, *Massively scalable stencil algorithm* (SC22),
the follow-on work the paper's §VII points to, step the constant-density
acoustic wave equation of seismic modelling (Minimod's isotropic kernel)
explicitly in time: second order in time, 8th-order central differences in
space (a 25-point star of radius 4), float32, one time step after another
with no solve.  For each point ``i`` with ``c_i = (v_i dt / h)^2``::

    u^{n+1}_i = 2 u^n_i - u^{n-1}_i + c_i * sum_axes [a_0 u^n_i
                + sum_{m=1..4} a_m (u^n_{i+m e} + u^n_{i-m e})]  (+ c_s w(n dt) at s)

with ``a_0 .. a_4`` = -205/72, 8/5, -1/5, 8/315, -1/560
(``core/stencil.py:_FD2_WEIGHTS``) and ``u`` zero outside the block (zero
Dirichlet).  This module is the time-stepper: a velocity model to ``c``
(:func:`velocity_to_c`), a Ricker wavelet (:class:`Ricker`), and
:func:`propagate_shot`, which marches one shot from rest (or from given
wavefields) with one launch a step.  The implicit ``I - theta L_8`` solves
of ``configs/stencil_star25_seismic.py`` are the repo's own construction;
this is the source's own workload.

Backends: ``fused`` runs K7 (``kernels/wave``: the whole step, source
included, in one launch, ``u^{n+1}`` written over ``u^{n-1}`` and the two
buffers swapped by reference); on CPU tensors K7's wrapper takes its plain
version.  ``plain`` runs the plain version (``kernels/wave/ref.py``) on any
device.  A shot makes no host sync between its steps and reads one flag at
its end: not finite, or past a blow-up bound.

Spans (live while ``--obs`` traces or ``torch.profiler`` records):
``wave.shot`` (one a shot) > ``wave.init`` (the wavefields, the source's
sample table, the launch plan), ``wave.step`` (one a step: the launch's
enqueue), ``wave.flag_wait`` (the flag's read, the shot's one wait on the
card).  Counters: ``wave.shots``, ``wave.steps``; K7's launches are
``kernels.wave_leapfrog.launches`` in a run bundle.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.stencil import _FD2_WEIGHTS
from repro_torch.kernels.wave.kernel import launch_plan, wave_leapfrog
from repro_torch.kernels.wave.ref import RADIUS, wave_leapfrog_ref
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

BACKENDS = ("fused", "plain")
#: a shot fails once a wavefield magnitude passes this many times the total
#: it was given: the source's samples and the starting wavefields' maxima
BLOWUP = 1e3


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def step_weights() -> tuple[float, ...]:
    """K7's tap weights as float32 values: ``wc = 3 a_0`` (the centre, once
    for the three axes), then ``a_1 .. a_4``."""
    a0, arms = _FD2_WEIGHTS[RADIUS]
    return (_f32(3.0 * a0), *(_f32(a) for a in arms))


def velocity_to_c(v: torch.Tensor, *, dt: float, h: float) -> torch.Tensor:
    """``c = (v dt / h)^2`` in float32, on ``v``'s device: the squared
    Courant number each point's step multiplies its Laplacian by."""
    q = v.to(torch.float32) * (float(dt) / float(h))
    return q * q


def gradient_velocity(shape: tuple[int, int, int], *, seed: int, device) -> torch.Tensor:
    """A velocity model in m/s (float32, on ``device``): 1500 to 4500 linearly
    with depth along Z (the contiguous axis; a smooth gradient, no layer
    interfaces), times ``1 + 0.05 p(x, y)``,
    with ``p`` a smooth field of ``|p| <= 1`` (a sum of cosines of at most
    two periods across X and Y, amplitudes and phases from ``seed``)."""
    top, bottom, lateral = 1500.0, 4500.0, 0.05
    nx, ny, nz = (int(s) for s in shape)
    gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
    kx, ky = torch.meshgrid(torch.arange(3), torch.arange(3), indexing="ij")
    amp = torch.rand(9, generator=gen, dtype=torch.float64)
    phase = 2.0 * math.pi * torch.rand(9, generator=gen, dtype=torch.float64)
    x = torch.arange(nx, dtype=torch.float64, device=device)[:, None] / nx
    y = torch.arange(ny, dtype=torch.float64, device=device)[None, :] / ny
    p = torch.zeros((nx, ny), dtype=torch.float64, device=device)
    for a, ph, i, j in zip(amp.tolist(), phase.tolist(), kx.flatten().tolist(),
                           ky.flatten().tolist()):
        p += a * torch.cos(2.0 * math.pi * (i * x + j * y) + ph)
    p /= float(amp.sum())
    depth = torch.arange(nz, dtype=torch.float64, device=device) / max(nz - 1, 1)
    profile = (top + (bottom - top) * depth).to(torch.float32)
    return profile[None, None, :] * (1.0 + lateral * p).to(torch.float32)[:, :, None]


@dataclasses.dataclass(frozen=True)
class WaveModel:
    """A medium on one block: ``c`` per point (float32, contiguous, 3-D), with
    the time step ``dt`` (s) and grid spacing ``h`` (m) it was made for."""
    c: torch.Tensor
    dt: float
    h: float

    @classmethod
    def from_velocity(cls, v: torch.Tensor, *, dt: float, h: float) -> "WaveModel":
        return cls(velocity_to_c(v, dt=dt, h=h).contiguous(), float(dt), float(h))


@dataclasses.dataclass(frozen=True)
class Ricker:
    """A Ricker wavelet, ``w(t) = (1 - 2 x) exp(-x)``, ``x = (pi f (t - t0))^2``:
    peak frequency ``peak_hz``, centred at ``delay_s``."""
    peak_hz: float
    delay_s: float

    def samples(self, steps: int, dt: float, device) -> torch.Tensor:
        """``w(n dt)`` for ``n = 0 .. steps-1``, computed in float64 on
        ``device`` (no host copy) and rounded to float32."""
        t = torch.arange(steps, dtype=torch.float64, device=device) * float(dt)
        x = (math.pi * self.peak_hz * (t - self.delay_s)) ** 2
        return ((1.0 - 2.0 * x) * torch.exp(-x)).to(torch.float32)


@dataclasses.dataclass
class ShotResult:
    """A shot's final wavefield ``u^n`` after ``steps`` steps, and whether it
    failed (a value not finite, or past the blow-up bound)."""
    u: torch.Tensor
    failed: bool
    steps: int


def flat_index(shape: tuple[int, ...], point: tuple[int, int, int]) -> int:
    """The element index of ``point`` in a contiguous ``shape`` block; a
    point outside raises."""
    if len(point) != 3 or not all(0 <= int(p) < int(n) for p, n in zip(point, shape)):
        raise ValueError(f"source {tuple(point)} lies outside the block {tuple(shape)}")
    x, y, z = (int(p) for p in point)
    return (x * int(shape[1]) + y) * int(shape[2]) + z


def _start(given: torch.Tensor | None, c: torch.Tensor) -> torch.Tensor:
    """A shot's own copy of a starting wavefield (zeros when none is given):
    the caller's tensor is never written."""
    if given is None:
        return torch.zeros_like(c)
    if given.shape != c.shape or given.device != c.device:
        raise ValueError(f"a starting wavefield is {tuple(given.shape)} on {given.device}; "
                         f"the model is {tuple(c.shape)} on {c.device}")
    return given.to(torch.float32).clone(memory_format=torch.contiguous_format)


def _amax(t: torch.Tensor) -> torch.Tensor:
    """``max |t|`` on ``t``'s device in one reduction (no ``|t|`` temporary)."""
    lo, hi = torch.aminmax(t)
    return torch.maximum(hi, -lo)


def propagate_shot(model: WaveModel, source: tuple[int, int, int], wavelet: Ricker,
                   steps: int, *, u0: torch.Tensor | None = None,
                   u_prev0: torch.Tensor | None = None, backend: str = "fused") -> ShotResult:
    """March one shot ``steps`` leapfrog steps and return its final ``u``.

    The source at grid point ``source`` injects ``c_s w(n dt)`` into step
    ``n``'s result.  ``u0``/``u_prev0`` are ``u^0`` and ``u^{-1}`` (zero by
    default: a shot from rest); they are copied, never written.  One launch
    a step, no host sync inside the shot; at its end one read of the failure
    flag: a value not finite, or a magnitude above :data:`BLOWUP` times the
    sum of the source's sample magnitudes and the starting wavefields' maxima.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if int(steps) < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    c = model.c
    if c.ndim != 3 or c.dtype != torch.float32 or not c.is_contiguous():
        raise ValueError(f"the model's c is a contiguous float32 block, got {c.dtype} "
                         f"{tuple(c.shape)}")
    weights = step_weights()
    with obs_trace.span("wave.shot", steps=int(steps), backend=backend, shape=tuple(c.shape)):
        with obs_trace.span("wave.init"):
            s = flat_index(tuple(c.shape), source)
            table = c.view(-1)[s] * wavelet.samples(int(steps), model.dt, c.device)
            u, w = _start(u0, c), _start(u_prev0, c)
            bound = table.abs().sum()
            for given, field in ((u0, u), (u_prev0, w)):
                if given is not None:
                    bound = bound + _amax(field)
            plan = launch_plan(tuple(c.shape)) if backend == "fused" else None
        obs_metrics.counter("wave.shots").inc()
        for n in range(int(steps)):
            with obs_trace.span("wave.step"):
                if backend == "fused":
                    wave_leapfrog(u, w, c, weights=weights, src_index=s, src=table[n], plan=plan)
                else:
                    w = wave_leapfrog_ref(u, w, c, weights, s, table[n])
                u, w = w, u
        obs_metrics.counter("wave.steps").inc(int(steps))
        del w
        with obs_trace.span("wave.flag_wait"):
            peak = _amax(u)                               # NaN where u holds one
            failed = bool(~torch.isfinite(peak) | (peak > BLOWUP * bound))
    return ShotResult(u, failed, int(steps))
