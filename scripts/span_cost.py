#!/usr/bin/env python3
"""What one of the port's spans costs the host, in microseconds an
enter and exit, on whatever CPU runs it (no card needed).

    python3 scripts/span_cost.py [--n 200000]

Each figure is the best of five timings.  Prints one JSON line: a span that is off (no tracing, no profiler: the
shared no-op), an empty loop for scale, a span live under the port's
tracing (``trace.enable()``), a bare ``record_function`` with no profiler,
and, under ``torch.profiler`` (CPU activity), a bare ``record_function``
and a live span (which opens one).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def per_call_us(body, n: int, repeats: int = 5) -> float:
    """The best of ``repeats`` timings of ``body(n)``, per call: the cost
    without what other work on the machine adds."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        body(n)
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    n = ap.parse_args(argv).n

    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    torch.set_num_threads(1)

    def spans(k):
        for _ in range(k):
            with trace.span("x"):
                pass

    def ranges(k):
        for _ in range(k):
            with record_function("x"):
                pass

    def empty(k):
        for _ in range(k):
            pass

    live_n = max(n // 10, 1)
    out = {"off_span_us": per_call_us(spans, n), "empty_loop_us": per_call_us(empty, n),
           "record_function_no_profiler_us": per_call_us(ranges, live_n)}
    trace.enable()
    out["traced_span_us"] = per_call_us(spans, live_n)
    trace.disable()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out["record_function_profiled_us"] = per_call_us(ranges, live_n)
        out["profiled_span_us"] = per_call_us(spans, live_n)
    trace.reset()
    out["torch"] = torch.__version__
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
