"""The program's own spans over the traced stretch, for the per-layer
metrics that read them (``metrics/enqueue_ms_per_iter.py``,
``metrics/setup_host_ms.py``).

The port records a span while ``torch.profiler`` records
(``repro_torch.obs.trace``), so after the window its span list holds the
traced stretch's solves and nothing else.  A program that records no such
spans gives nothing to read, and the readers then return None.
"""

from __future__ import annotations


def host_ms(run, name: str, less: str) -> float | None:
    """Host milliseconds that the spans called ``name`` spend outside their
    children called ``less``, summed over the stretch; None unless the
    program recorded exactly one ``solve`` span per solve of the stretch and
    one ``krylov.iteration`` span per iteration."""
    from repro_torch.obs import trace

    events = trace.events()
    count = {"solve": 0, "krylov.iteration": 0}
    for e in events:
        if e["name"] in count:
            count[e["name"]] += 1
    if (not run.stretch_solves or count["solve"] != len(run.stretch_solves)
            or count["krylov.iteration"] != run.stretch_iterations):
        return None
    own = trace.self_us(events, (less,))
    return sum(own[e["id"]] for e in events if e["name"] == name) * 1e-3
