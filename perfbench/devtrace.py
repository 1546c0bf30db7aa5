"""Reduces a ``torch.profiler`` trace of a stretch of the window to what the
per-layer metrics and the ``breakdown`` read: the device's operations in the
stretch, the time the device was busy, and the idle gaps named by what the
host was doing in them.

Only the event list in memory is read; nothing is written.  The stretch is
marked by a ``record_function`` range (:data:`STRETCH`), whose host interval
is the traced window.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from pathlib import Path

STRETCH = "perfbench.stretch"
#: how far back the host lookup of one gap scans the event list
_SCAN = 4000

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*[<(]")


def handwritten_kernels(csrc: Path) -> frozenset[str]:
    """Names of the ``__global__`` functions in the program's CUDA sources."""
    names = set()
    for f in sorted(Path(csrc).glob("*.cu*")):
        names.update(_GLOBAL.findall(f.read_text()))
    return frozenset(names)


def short_name(kernel: str) -> str:
    """A device function's name without its return type, namespace
    arguments, template arguments and parameters."""
    name = kernel.strip()
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if depth == 0 and ch == "(" and out:
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or kernel


@dataclasses.dataclass
class DeviceOp:
    name: str            # the device function's short name (or Memcpy/Memset)
    host_op: str         # the aten op that launched it, where the trace links one
    start_us: float
    end_us: float
    is_kernel: bool

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    @property
    def base(self) -> str:
        """The name without its namespaces: what a ``__global__`` declares."""
        return self.name.rsplit("::", 1)[-1]


@dataclasses.dataclass
class Stretch:
    """The traced stretch: its host interval, the device's operations in
    it, and the idle gaps between them with the host op open at each."""
    window_s: float
    ops: list[DeviceOp]
    busy_s: float
    gaps: list[tuple[str, float]]

    @property
    def kernels(self) -> list[DeviceOp]:
        return [o for o in self.ops if o.is_kernel]

    def device_ops(self, top: int = 10) -> list[list]:
        """The operations that took the most device time, summed by name."""
        tot: dict[str, float] = defaultdict(float)
        for o in self.ops:
            tot[o.name if not o.host_op else f"{o.name} [{o.host_op}]"] += o.seconds
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle time summed by what the host was doing, with the number of
        gaps, longest first."""
        tot: dict[str, float] = defaultdict(float)
        cnt: dict[str, int] = defaultdict(int)
        for name, s in self.gaps:
            tot[name] += s
            cnt[name] += 1
        return [[f"{k} (x{cnt[k]})", v]
                for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _is_annotation(e) -> bool:
    """A ``record_function`` range, which the trace repeats on the device's
    timeline; it is no device operation."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith("perfbench.")


def reduce_events(events) -> Stretch:
    """A :class:`Stretch` from ``prof.events()``."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not _is_annotation(e):
                device.append(e)
        else:
            host.append(e)
    marks = [e for e in host if e.name == STRETCH]
    if not marks:
        raise RuntimeError(f"the trace has no {STRETCH!r} range")
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    thread = marks[0].thread
    main = sorted((e for e in host if e.thread == thread and e.name != STRETCH),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in main]
    # a kernel shares its correlation id with the runtime call that launched it
    launches = {e.id: e for e in host if e.name.startswith("cuda")}
    ops = []
    for e in device:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        raw = e.name
        is_kernel = not raw.startswith(("Memcpy", "Memset"))
        call = launches.get(e.id)
        host_op = _aten_at(main, starts, call.time_range.start) if call is not None else ""
        ops.append(DeviceOp(short_name(raw) if is_kernel else raw.split(" (")[0], host_op,
                            a, b, is_kernel))
    busy = _union([(o.start_us, o.end_us) for o in ops])
    busy_s = sum(b - a for a, b in busy) * 1e-6

    gaps = []
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((_host_at(main, starts, (a + b) / 2), (b - a) * 1e-6))
    return Stretch((w1 - w0) * 1e-6, ops, busy_s, gaps)


def _aten_at(main, starts, t: float) -> str:
    """The innermost ``aten::`` op open at time ``t`` on the host, or ''."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(main[max(0, i - _SCAN):i]):
        if e.time_range.end >= t and e.name.startswith("aten::"):
            return e.name
    return ""


def _host_at(main, starts, t: float) -> str:
    """The innermost host range open at time ``t``, with its innermost
    ``aten::`` ancestor when it is not one itself."""
    i = bisect.bisect_right(starts, t)
    inner, aten = None, None
    for e in reversed(main[max(0, i - _SCAN):i]):
        if e.time_range.end < t:
            continue
        if inner is None:
            inner = e.name
        if e.name.startswith("aten::"):
            aten = e.name
            break
    if inner is None:
        return "host outside any op"
    return inner if aten in (None, inner) else f"{aten} > {inner}"
