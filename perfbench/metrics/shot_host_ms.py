"""Host milliseconds per shot spent in the shot outside its time steps and
its one wait on the card: each ``wave.shot`` span of the traced stretch less
its ``wave.step`` and ``wave.flag_wait`` children, summed and divided by the
stretch's shots.  This is the shot's set-up (``wave.init``: the zeroed
wavefields, the source's sample table, the launch plan), the result's
assembly, and the spans' own cost.  Layer: the shot set-up
(``core/wave.propagate_shot``).

The reading helper is this file's own: ``perfbench/spans.py`` reads the
Krylov solve's spans.
"""

UNIT = "ms"
LAYER = "shot set-up"
MOVES = "solve_s"
#: the children of ``wave.shot`` whose time is not set-up
NOT_SETUP = ("wave.step", "wave.flag_wait")


def shot_host_ms(run) -> float | None:
    """The summed host ms of the stretch's ``wave.shot`` spans outside their
    :data:`NOT_SETUP` children; None unless the program recorded exactly one
    ``wave.shot`` span per shot of the stretch and one ``wave.step`` span per
    step."""
    from repro_torch.obs import trace

    events = trace.events()
    count = {"wave.shot": 0, "wave.step": 0}
    for e in events:
        if e["name"] in count:
            count[e["name"]] += 1
    if (not run.stretch_solves or count["wave.shot"] != len(run.stretch_solves)
            or count["wave.step"] != run.stretch_iterations):
        return None
    own = trace.self_us(events, NOT_SETUP)
    return sum(own[e["id"]] for e in events if e["name"] == "wave.shot") * 1e-3


def read(run):
    ms = shot_host_ms(run)
    return None if ms is None else ms / len(run.stretch_solves)
