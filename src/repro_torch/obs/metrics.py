"""Process-local metrics registry: counters, gauges, histograms, events.

Counterpart of ``repro/obs/metrics.py``, with its semantics.  One global
:class:`Registry` collects what a run emits: solver iterations and per-RHS
convergence (from a ``SolveResult``), residual histories, collective counts,
kernel launch counts, tuning-cache lookups, and the achieved share of the
card's peak.  The registry is always on (a counter bump is a dict lookup and
an integer add); spans are the opt-in part of observability.

Two departures from the JAX package, both because nothing is traced here:

* there is no HLO, so :func:`record_collectives` takes counts the port's own
  counters made (``comm.allreduce``, bumped where each AllReduce runs, and
  ``comm.ppermute``, 2 per split fabric axis per halo exchange, as the JAX
  package counts its ``fwd`` and ``bwd`` permutes) instead of counting ops
  in lowered text.  These are counts of what *ran*: a loop of n iterations
  counts its body n times, where the JAX package counts the body's ops once
  in the program.  The one-rank fabric sends no halo message, so
  ``ppermute_total`` is 0 there;
* there are no tracers, so every value fed to :func:`record_solve` is
  concrete and there is no ``is_concrete`` guard.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming summary + a bounded reservoir of raw observations."""

    MAX_SAMPLES = 1024
    __slots__ = ("count", "total", "min", "max", "last", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.last = None
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.last = v
        if len(self.samples) < self.MAX_SAMPLES:
            self.samples.append(v)

    def summary(self) -> dict:
        mean = self.total / self.count if self.count else None
        return {"count": self.count, "total": self.total, "mean": mean,
                "min": self.min, "max": self.max, "last": self.last}


class Registry:
    """Process-local named metrics plus an append-only event log."""

    MAX_EVENTS = 100_000

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.events: list[dict] = []

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self.counters.get(name)
            if c is None:
                c = self.counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self.histograms.setdefault(name, Histogram())

    def event(self, kind: str, /, **fields) -> dict:
        ev = {"ts": time.time(), "event": kind, **fields}
        with self._lock:
            if len(self.events) < self.MAX_EVENTS:
                self.events.append(ev)
        return ev

    def snapshot(self) -> dict:
        """JSON-ready view of every metric (events go to ``events.jsonl``
        through the run manifest)."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self.counters.items()},
                "gauges": {k: g.value for k, g in self.gauges.items()},
                "histograms": {k: h.summary() for k, h in self.histograms.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self.events.clear()


REGISTRY = Registry()

# Module-level conveniences bound to the global registry.
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
event = REGISTRY.event
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset


def events() -> list[dict]:
    with REGISTRY._lock:
        return list(REGISTRY.events)


# ---------------------------------------------------------------------------
# Collective counts (executed, from the port's counters)

#: the counters a collective bumps where it runs (core/operator.py's
#: reductions, core/dist.py's exchanges), under the bundle's keys
COLLECTIVE_COUNTERS = {"allreduce_total": "comm.allreduce", "ppermute_total": "comm.ppermute"}


def collective_counts() -> dict[str, int]:
    """The collective counters' current values, under the bundle's keys."""
    return {k: counter(name).value for k, name in COLLECTIVE_COUNTERS.items()}


def record_collectives(counts: dict, *, per_rank: list | None = None, **labels) -> dict:
    """Mirror AllReduce / ppermute totals into gauges and append a
    ``collectives`` event carrying the labels (solver, schedule, nrhs...).

    ``counts`` holds ``allreduce_total`` (e.g. the difference of
    :func:`collective_counts` around one solve) and, where halo messages
    were sent, ``ppermute_total`` (0 when absent: none on one rank).
    ``per_rank`` (a multi-rank run) lists every rank's own counts, in rank
    order, and rides the event beside this rank's."""
    counts = {k: int(counts.get(k, 0)) for k in ("allreduce_total", "ppermute_total")}
    prefix = labels.get("solver", "solve")
    gauge(f"collectives.{prefix}.allreduce_total").set(counts["allreduce_total"])
    gauge(f"collectives.{prefix}.ppermute_total").set(counts["ppermute_total"])
    extra = {} if per_rank is None else {"per_rank": per_rank}
    event("collectives", **labels, **counts, **extra)
    return counts


# ---------------------------------------------------------------------------
# Roofline accounting (the paper's achieved-vs-peak framing).

def roofline_fraction(achieved_flops_per_s: float,
                      peak_flops_per_s: float | None = None) -> float:
    """Achieved / peak FLOP fraction; peak defaults to the performance
    model's ``PEAK_FLOPS`` (the H100's f32 rate, data sheet)."""
    if peak_flops_per_s is None:
        from repro_torch.core import perfmodel

        peak_flops_per_s = perfmodel.PEAK_FLOPS
    frac = achieved_flops_per_s / peak_flops_per_s
    gauge("roofline.achieved_flops_per_s").set(achieved_flops_per_s)
    gauge("roofline.fraction").set(frac)
    return frac


# ---------------------------------------------------------------------------
# Per-solve emission from a SolveResult

def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.dtype.is_floating_point:
            x = x.double()
        return x.numpy()
    return np.asarray(x)


def record_solve(result, *, wall_s: float | None = None, **labels) -> dict:
    """Emit iterations / convergence / residual metrics for one solve.

    ``result`` is any ``SolveResult``-shaped object whose fields are
    tensors (on any device) or arrays.  ``history[k]`` is the relative
    residual after iteration k+1, for every solver."""
    iters = _host(result.iterations)
    conv = _host(result.converged)
    rel = _host(result.rel_residual)
    brk = _host(result.breakdown)
    n_rhs = int(iters.size)

    counter("solve.total").inc()
    counter("solve.rhs_total").inc(n_rhs)
    counter("solve.rhs_converged").inc(int(conv.sum()))
    counter("solve.breakdowns").inc(int(brk.sum()))
    for it in iters.reshape(-1):
        histogram("solve.iterations").observe(float(it))
    gauge("solve.iterations_max").set(float(iters.max()))
    gauge("solve.rel_residual_max").set(float(rel.max()))
    if wall_s is not None:
        histogram("solve.wall_s").observe(wall_s)
        gauge("solve.solves_per_sec").set(n_rhs / wall_s if wall_s else 0.0)

    ev = {
        "iterations": iters.reshape(-1).astype(int).tolist(),
        "converged": conv.reshape(-1).astype(bool).tolist(),
        "rel_residual": rel.reshape(-1).astype(float).tolist(),
        "breakdown": brk.reshape(-1).astype(bool).tolist(),
        "n_rhs": n_rhs,
    }
    if wall_s is not None:
        ev["wall_s"] = wall_s
    hist = getattr(result, "history", None)
    if hist is not None:
        ev["history"] = _host(hist).astype(float)[: int(iters.max())].tolist()
    return event("solve", **labels, **ev)
