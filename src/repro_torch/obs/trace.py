"""Nestable spans with Chrome-trace export; a shared no-op when disabled.

Counterpart of ``repro/obs/trace.py``.  What changes under eager PyTorch:

* a span wraps code that runs as it is called, so it fires on *every* call
  (once per SpMV inside the solve loop), where the JAX package's fires once
  per trace;
* its duration is host time.  For CUDA work that is the time to enqueue it,
  unless the span synchronises: with sync timing on (``enable(sync=True)``
  or a span's own ``sync=True``), ``Span.block(value)`` waits for the card
  (``torch.cuda.synchronize``) before the span closes::

      with trace.span("solve", solver="bicgstab") as sp:
          res = solve(...)
          sp.block(res.x)

A span is *live* while the port's tracing is enabled (:func:`enable`, as
``--obs`` does) or while ``torch.profiler`` records.  A live span records
its host interval; while the profiler records it also opens a
``record_function`` range of its name, so the span sits on the profiler's
timeline, on one clock with the kernels launched inside it (``--profile``'s
``torch_trace.json``, the benchmark's traced run).  When neither is on,
:func:`span` returns one shared no-op object and opens no range, so an
instrumented loop pays a function call and two flag tests per span.

Each recorded span carries its ``id``, its parent's ``parent_id`` and
``solve_id``, the id of the outermost ``solve`` span it runs in, so that
every span of one solve shares it; :func:`self_us` gives a span's duration
less what its children cover.  At most :data:`MAX_EVENTS` spans are kept;
the counter ``trace.dropped`` counts the rest.

``chrome_trace()`` returns the completed spans as Chrome trace events
(``ph: "X"``, microsecond timestamps; load ``trace.json`` at
https://ui.perfetto.dev).  ``profile(dir)`` runs a region under
``torch.profiler`` and writes its Chrome trace into ``dir``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

from torch.autograd import profiler as _torch_profiler

from repro_torch.obs import metrics as obs_metrics

#: spans kept in memory; later ones are counted in ``trace.dropped``
MAX_EVENTS = 100_000

_ENABLED = False
_SYNC = False
_EVENTS: list[dict] = []
_IDS = itertools.count(1)
_LOCK = threading.Lock()
_TLS = threading.local()
# Process epoch: Chrome trace timestamps are relative microseconds.
_EPOCH = time.perf_counter()


def enable(*, sync: bool = False) -> None:
    """Turn span recording on; ``sync=True`` makes ``Span.block`` wait for
    the card, so span durations include device execution."""
    global _ENABLED, _SYNC
    _ENABLED = True
    _SYNC = bool(sync)


def disable() -> None:
    global _ENABLED, _SYNC
    _ENABLED = False
    _SYNC = False


def is_enabled() -> bool:
    """Whether the port's own tracing is on (``enable``); a profiler that
    records makes spans live without turning it on."""
    return _ENABLED


def reset() -> None:
    """Drop all recorded spans (and any dangling thread-local stacks)."""
    with _LOCK:
        _EVENTS.clear()
    _TLS.stack = []


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class Span:
    """A single recorded span.  Use via :func:`span`, not directly."""

    __slots__ = ("name", "attrs", "t0", "depth", "parent", "id", "solve_id", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.depth = 0
        self.parent = None
        self.id = next(_IDS)
        self.solve_id = None
        self._range = None

    def __enter__(self) -> "Span":
        st = _stack()
        self.parent = st[-1] if st else None
        self.depth = len(st)
        self.solve_id = self.parent.solve_id if self.parent else None
        if self.solve_id is None and self.name == "solve":
            self.solve_id = self.id
        st.append(self)
        if _torch_profiler._is_profiler_enabled:
            self._range = _torch_profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        ev = {
            "name": self.name,
            "ts_us": (self.t0 - _EPOCH) * 1e6,
            "dur_us": (t1 - self.t0) * 1e6,
            "depth": self.depth,
            "parent": self.parent.name if self.parent else None,
            "thread": threading.get_ident(),
            "id": self.id,
            "parent_id": self.parent.id if self.parent else None,
            "solve_id": self.solve_id,
        }
        if self.attrs:
            ev["attrs"] = self.attrs
        with _LOCK:
            kept = len(_EVENTS) < MAX_EVENTS
            if kept:
                _EVENTS.append(ev)
        if not kept:
            obs_metrics.counter("trace.dropped").inc()

    def block(self, value):
        """Synchronise ``value``'s card iff sync timing is on and ``value``
        is a CUDA tensor (a CPU tensor is already computed); always returns
        ``value``, so call sites can write ``x = sp.block(x)``."""
        if _SYNC or self.attrs.get("sync"):
            device = getattr(value, "device", None)
            if device is not None and device.type == "cuda":
                import torch

                torch.cuda.synchronize(device)
        return value

    def set(self, **attrs) -> None:
        """Attach extra attributes to the span after entry."""
        self.attrs.update(attrs)


class _NullSpan:
    """Singleton stand-in when tracing is disabled: every method is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def block(self, value):
        return value

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


def span(name: str, **attrs):
    """Open a (nestable) span.  Returns the no-op singleton unless tracing
    is enabled or ``torch.profiler`` records."""
    if not (_ENABLED or _torch_profiler._is_profiler_enabled):
        return _NULL
    return Span(name, attrs)


def events() -> list[dict]:
    """Completed spans, oldest first (a copy)."""
    with _LOCK:
        return list(_EVENTS)


def self_us(events: list[dict], children: tuple[str, ...] | None = None) -> dict[int, float]:
    """Each span's self time in microseconds, by ``id``: its duration less
    what its children cover (only the children named in ``children``, when
    given).  A span's children run one after another on its thread."""
    out = {e["id"]: e["dur_us"] for e in events}
    for e in events:
        if e["parent_id"] in out and (children is None or e["name"] in children):
            out[e["parent_id"]] -= e["dur_us"]
    return out


def chrome_trace() -> dict:
    """Completed spans as a Chrome trace-event document (Perfetto-loadable)."""
    pid = os.getpid()
    out = []
    with _LOCK:
        for ev in _EVENTS:
            out.append({
                "name": ev["name"],
                "ph": "X",
                "ts": ev["ts_us"],
                "dur": ev["dur_us"],
                "pid": pid,
                "tid": ev["thread"],
                "args": dict(ev.get("attrs", {}), depth=ev["depth"]),
            })
    out.sort(key=lambda e: e["ts"])
    return {"traceEvents": out, "displayTimeUnit": "ms"}


#: file name of the profiler's Chrome trace inside a ``profile`` directory
PROFILE_TRACE = "torch_trace.json"


def device_time_us(prof) -> float:
    """Total self time of CUDA-device events in a finished profile."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


class Profile:
    """A region under ``torch.profiler`` whose Chrome trace goes to
    ``<log_dir>/torch_trace.json`` when it stops.

    ``cuda`` (default: ``torch.cuda.is_available()``) asks for CUDA activity
    too, and then a profile that recorded no device time raises: a run on
    the card whose trace shows no kernel traced nothing worth keeping.  A
    profiler that cannot start raises as well; nothing here falls back to an
    unprofiled run.
    """

    def __init__(self, log_dir: str, *, cuda: bool | None = None):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.log_dir = log_dir
        self.cuda = torch.cuda.is_available() if cuda is None else bool(cuda)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        os.makedirs(log_dir, exist_ok=True)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    @property
    def trace_path(self) -> str:
        return os.path.join(self.log_dir, PROFILE_TRACE)

    def stop(self, *, check: bool = True) -> None:
        """Stop profiling, export the trace, and (``check``) raise if a CUDA
        profile recorded no device activity."""
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(self.trace_path)
        if check and self.cuda and device_time_us(self._prof) <= 0:
            raise RuntimeError(f"the profile in {self.log_dir} recorded no CUDA device "
                               f"activity; torch.profiler did not trace the card")


@contextlib.contextmanager
def profile(log_dir: str, *, cuda: bool | None = None):
    """Run a region under :class:`Profile` (the ``--profile`` hook)."""
    prof = Profile(log_dir, cuda=cuda)
    ok = False
    try:
        yield prof
        ok = True
    finally:
        prof.stop(check=ok)
