"""Observability for the port: spans, metrics, and run manifests.

Counterpart of ``repro/obs``, in three small modules that import nothing of
``repro_torch.core`` at module level (the core modules import *them*):

* :mod:`repro_torch.obs.trace`: nestable context-manager spans with opt-in
  device-synchronised timing and Chrome-trace (Perfetto) export, and
  ``profile`` around ``torch.profiler``;
* :mod:`repro_torch.obs.metrics`: a process-local registry of counters,
  gauges, histograms and structured events (solver iterations, per-RHS
  convergence, executed AllReduce counts, kernel launches, the achieved
  share of peak);
* :mod:`repro_torch.obs.manifest`: run bundles under
  ``results/runs/<run_id>/{manifest.json,events.jsonl,trace.json}`` in the
  JAX package's ``repro.obs.v1`` schema, so ``scripts/compare_runs.py``
  diffs the port's bundles unchanged.
"""

from repro_torch.obs import manifest, metrics, trace

__all__ = ["manifest", "metrics", "trace"]
