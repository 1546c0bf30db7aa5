"""One reader per metric, found by the metric's name in ``BENCHMARK.json``.

Each module states its ``UNIT``, ``LAYER`` (per-layer metrics) and the
end-to-end metric it ``MOVES``, and defines ``read(run)``: the metric's value
from a :class:`perfbench.harness.RunRecord`, or None where the run holds
nothing for it to read (the harness then leaves it out of the line).
"""
