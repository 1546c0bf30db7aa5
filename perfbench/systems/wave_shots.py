"""A closed stream of explicit wave-propagation shots through the port's
``repro_torch.core.wave.propagate_shot``, on one card.

Set-up makes the medium from the seed on the device (the configuration's
operator module: a velocity model, 1500 to 4500 m/s with depth and a smooth
lateral perturbation), hands the velocity to the program, which forms its
``c`` once, and draws the traffic's pool of shot positions from the seed.
Each step of the stream is one shot of the traffic's ``iterations`` time
steps from rest, waited for at its end, as a migration job runs one shot
after another; the program's per-shot set-up (zeroed wavefields, the
wavelet's table, the launch plan) is inside each shot.

:meth:`System.numbers` judges the window's answers against the plain
reference (``perfbench/reference/wave.py``): the final wavefield of the
last shot the window ran for each checked pool entry (``u_gap``,
``u_gap_max``), and one step on the whole grid from wavefields drawn from
the seed, made after the window (``step_gap``): in 200 steps a shot's wave
reaches only some tens of points, so this step is what reads every tile and
segment edge of the grid.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time

import numpy as np
import torch

from perfbench import registry
from perfbench.reference import wave as ref_wave

#: elements per chunk of a norm or a gap (their float64 copies stay small)
CHUNK = 1 << 26
#: the controls: the reference a step below what the configuration states
CONTROLS = {"bf16_storage": dict(storage=torch.bfloat16), "fd4_13_point": dict(radius=2)}
#: the pool entry whose shot the step check puts its source at
STEP_KEY = "step"


def seed_for(seed: int, k: int) -> int:
    """The generator seed of draw ``k`` under the run's ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), k])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


@dataclasses.dataclass
class Answer:
    """A final wavefield and whether the program flagged its run as failed."""
    u: torch.Tensor
    failed: bool


@dataclasses.dataclass
class ShotRecord:
    pool: int
    iterations: int                # time steps the shot ran
    failed: bool
    wall_s: float


def _norm2(a: torch.Tensor, b: torch.Tensor | None = None) -> float:
    """``||a - b||`` (or ``||a||``) in float64, chunk by chunk."""
    a = a.reshape(-1)
    b = None if b is None else b.reshape(-1)
    tot = 0.0
    for i in range(0, a.numel(), CHUNK):
        d = a[i:i + CHUNK].double()
        if b is not None:
            d = d - b[i:i + CHUNK].double()
        tot += float(d.square().sum())
    return math.sqrt(tot)


def _amax(a: torch.Tensor, b: torch.Tensor | None = None) -> float:
    """``max |a - b|`` (or ``max |a|``), chunk by chunk; NaN anywhere reads NaN."""
    a = a.reshape(-1)
    b = None if b is None else b.reshape(-1)
    m = 0.0
    for i in range(0, a.numel(), CHUNK):
        d = a[i:i + CHUNK].double()
        if b is not None:
            d = d - b[i:i + CHUNK].double()
        v = float(d.abs().max())
        if math.isnan(v):
            return v
        m = max(m, v)
    return m


def shot_sources(shape, pool: int, depth: int, seed: int) -> tuple[list, int]:
    """The pool's source points and the index of the one near a side face:
    every source at depth index ``depth``; all but one with x and y in the
    middle half of the grid; that one (its index drawn from the seed)
    within 4 points of an X or a Y face, so that its stencil reads the zero
    halo from the first step."""
    rng = random.Random(seed)
    nx, ny, _ = shape
    out = [[rng.randrange(nx // 4, nx - nx // 4), rng.randrange(ny // 4, ny - ny // 4), depth]
           for _ in range(pool)]
    near = rng.randrange(pool)
    axis, off = rng.randrange(2), rng.randrange(4)
    n = shape[axis]
    out[near][axis] = off if rng.randrange(2) == 0 else n - 1 - off
    return [tuple(s) for s in out], near


class System:
    """One cell's inputs and its timed call.  ``wrap`` replaces the port's
    shot by ``wrap(propagate)``, ``propagate(source, steps, **starting
    fields)`` (the tests plant faults with it)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, *, wrap=None):
        from repro_torch.core import wave      # first: a program without it fails here, at once

        if config["policy"] != "f32":
            raise ValueError(f"the wave system runs float32, got policy {config['policy']!r}")
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.op = registry.operator(config["operator"]["kind"])
        self.params = config["operator"]["params"]
        self.radius = int(self.params["radius"])
        self.shape = tuple(int(s) for s in traffic["mesh"])
        self.steps = int(traffic["iterations"])
        wl = traffic["wavelet"]
        self.wavelet = (float(wl["peak_hz"]), float(wl["delay_s"]))
        self.sources, self.near_face = shot_sources(self.shape, int(traffic["pool"]),
                                                    int(traffic["source_depth"]), seed)
        others = [k for k in range(len(self.sources)) if k != self.near_face]
        picked = random.Random(seed_for(seed, 1)).sample(others,
                                                         int(traffic["check_sample"]) - 1)
        self.checked = sorted([self.near_face, *picked])
        self.kept: dict = {}
        model = wave.WaveModel.from_velocity(self._velocity(), dt=float(self.params["dt_s"]),
                                             h=float(self.params["h_m"]))
        ricker = wave.Ricker(*self.wavelet)
        backend = config["backend"]

        def propagate(source, steps, **fields):
            return wave.propagate_shot(model, source, ricker, steps, backend=backend, **fields)

        self.propagate = propagate if wrap is None else wrap(propagate)

    def _velocity(self) -> torch.Tensor:
        return self.op.velocity(self.shape, self.params, self.seed, self.device)

    def facts(self) -> dict:
        """What the metrics' byte counts take from the cell."""
        return dict(points=math.prod(self.shape), itemsize=4, solver=self.traffic["solver"],
                    steps=self.steps)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, i: int) -> ShotRecord:
        """Shoot pool entry ``i mod pool`` from rest and wait for it."""
        k = i % len(self.sources)
        t0 = time.perf_counter()
        res = self.propagate(self.sources[k], self.steps)
        self._sync()
        wall = time.perf_counter() - t0
        if k in self.checked:
            self.kept[k] = Answer(res.u, bool(res.failed))
        return ShotRecord(k, int(res.steps), bool(res.failed) or int(res.steps) != self.steps,
                          wall)

    def _step_fields(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``u^n`` and ``u^{n-1}`` of the step check: white noise from the seed."""
        out = []
        for j in (2, 3):
            gen = torch.Generator(device=self.device).manual_seed(seed_for(self.seed, j))
            out.append(torch.randn(self.shape, generator=gen, device=self.device))
        return out[0], out[1]

    def close_window(self) -> None:
        """The step check's one step through the program, then drop what the
        program holds beyond the kept answers."""
        if self.propagate is not None:
            u0, w0 = self._step_fields()
            res = self.propagate(self.sources[0], 1, u0=u0, u_prev0=w0)
            self.kept[STEP_KEY] = Answer(res.u, bool(res.failed))
            del u0, w0, res
        self.propagate = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def _c(self) -> torch.Tensor:
        return self.op.c_of(self._velocity(), self.params)

    def reference_answers(self, **control) -> dict:
        """The reference's answers (``control``: one of :data:`CONTROLS`'
        settings, else as the configuration states) for the checked pool
        entries and the step check."""
        c = self._c()
        dt = float(self.params["dt_s"])
        samples = ref_wave.ricker(self.steps, dt, *self.wavelet)
        radius = control.get("radius", self.radius)
        storage = control.get("storage", torch.float32)
        out = {k: Answer(ref_wave.shot(c, self.sources[k], samples, self.steps, radius=radius,
                                       storage=storage), False)
               for k in self.checked}
        src = self.sources[0]
        u0, w0 = self._step_fields()
        term = float(c[src]) * ref_wave.ricker(1, dt, *self.wavelet)[0]
        out[STEP_KEY] = Answer(ref_wave.one_step(u0, w0, c, src, term, radius=radius,
                                                 storage=storage), False)
        return out

    def control_answers(self, control: str = "bf16_storage") -> dict:
        return self.reference_answers(**CONTROLS[control])

    def numbers(self, answers: dict) -> dict:
        """The numbers ``correct`` compares, each the worst over the checked
        shots.  A reading that is not finite counts as infinite; a missing
        answer reads infinite."""
        out = dict(u_gap=0.0, u_gap_max=0.0, step_gap=0.0)

        def worst(name: str, value: float) -> None:
            out[name] = max(out[name], value if math.isfinite(value) else math.inf)

        want = self.reference_answers()
        for k in [*self.checked, STEP_KEY]:
            got = answers.get(k)
            names = ("step_gap",) if k == STEP_KEY else ("u_gap", "u_gap_max")
            if got is None:
                for name in names:
                    worst(name, math.inf)
                continue
            ref = want[k].u
            gap_max = _amax(got.u, ref) / max(_amax(ref), 1e-300)
            if k == STEP_KEY:
                worst("step_gap", gap_max)
            else:
                worst("u_gap", _norm2(got.u, ref) / max(_norm2(ref), 1e-300))
                worst("u_gap_max", gap_max)
        return out
