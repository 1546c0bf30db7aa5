"""The readers of the program's spans (``enqueue_ms_per_iter``,
``setup_host_ms``) on a traced run driven on the CPU at a small mesh, and
their refusal to read a span list that does not match the stretch."""

import functools
import math
import types

import pytest

from perfbench import harness, registry

MANIFEST = registry.load_manifest()
CELL = "cs1_star7.joule600"
SEED = 2**31 + 29
READERS = ("enqueue_ms_per_iter", "setup_host_ms")


@functools.cache
def _traced():
    """One traced run, and the spans the program recorded in it."""
    from repro_torch.obs import trace

    trace.reset()
    res, _ = harness.run_cell(MANIFEST, CELL, seed=SEED, seconds=0.5, traced=True,
                              device="cpu", t_start=0.0,
                              traffic_override={"mesh": [20, 18, 24]})
    return res, trace.events()


def _counts(events):
    return (sum(e["name"] == "solve" for e in events),
            sum(e["name"] == "krylov.iteration" for e in events))


def _read(name, events, solves, iterations, monkeypatch):
    from repro_torch.obs import trace

    monkeypatch.setattr(trace, "events", lambda: list(events))
    run = types.SimpleNamespace(stretch_solves=[None] * solves, stretch_iterations=iterations)
    return registry.metric(name).read(run)


@pytest.mark.parametrize("name", READERS)
def test_traced_run_reports_it(name):
    res, events = _traced()
    solves, iterations = _counts(events)
    assert solves > 0 and iterations == 6 * solves
    value = res["metrics"][name]["value"]
    assert math.isfinite(value) and value > 0


@pytest.mark.parametrize("name", READERS)
def test_reads_the_spans_it_names(name, monkeypatch):
    res, events = _traced()
    solves, iterations = _counts(events)
    assert _read(name, events, solves, iterations, monkeypatch) == res["metrics"][name]["value"]


@pytest.mark.parametrize("name", READERS)
def test_none_where_the_spans_do_not_match_the_stretch(name, monkeypatch):
    _, events = _traced()
    solves, iterations = _counts(events)
    assert _read(name, events, solves + 1, iterations, monkeypatch) is None
    assert _read(name, events, solves, iterations - 1, monkeypatch) is None
    one_less = [e for e in events if e["name"] != "krylov.iteration"] + [
        e for e in events if e["name"] == "krylov.iteration"][1:]
    assert _read(name, one_less, solves, iterations, monkeypatch) is None
    assert _read(name, [], solves, iterations, monkeypatch) is None
