"""The wave cell, ``rtm_star25.shots``: a run driven on the CPU at a small
mesh through ``harness.run_cell`` is correct under the cell's own limits,
and each of the two controls and each planted fault is not; the byte count
its rooflines read; its reference; its span reader.

The cell's system (``systems/wave_shots.py``) shoots through the port's
``repro_torch.core.wave.propagate_shot``, whose ``fused`` backend takes K7's
plain version on CPU tensors; the reference (``reference/wave.py``) imports
nothing of the port.
"""

import dataclasses
import functools
import math
import sys
import types

import pytest
import torch

from perfbench import harness, registry
from perfbench.metrics import leapfrog_roofline, step_roofline
from perfbench.reference import wave as ref_wave
from perfbench.systems import wave_shots

MANIFEST = registry.load_manifest()
CELL = "rtm_star25.shots"
#: a small mesh; at 3 s a window shoots every pool entry at least once
SMALL = [34, 30, 40]
SEED = 2**33 + 41
W = registry.workload(MANIFEST, CELL)
CONFIG = registry.load_config(MANIFEST, W["config"])


def _traffic(**kw):
    return dict(registry.load_traffic(W["traffic"]), mesh=SMALL, **kw)


def _run(wrap=None, traced=False, seconds=3.0):
    return harness.run_cell(MANIFEST, CELL, seed=SEED, seconds=seconds, traced=traced,
                            device="cpu", t_start=0.0, wrap=wrap,
                            traffic_override={"mesh": SMALL})[0]


@functools.cache
def _sound():
    return _run()


def _assert_sound():
    res = _sound()
    assert res["correct"] is True and res["failed"] == 0, res["check"]
    assert set(res["check"]) == {"u_gap", "u_gap_max", "step_gap", "failed_solves"}
    assert res["attempted"] > 0


def test_sound_run_is_correct():
    _assert_sound()
    res = _sound()
    assert {"ms_per_iter", "solve_s", "setup_s"} <= set(res["metrics"])
    assert all(v["value"] < v["limit"] / 10 for k, v in res["check"].items()
               if k != "failed_solves")


@pytest.mark.parametrize("control", sorted(wave_shots.CONTROLS))
def test_control_fails_the_cells_limits(control):
    sut = wave_shots.System(CONFIG, _traffic(), SEED, "cpu")
    nums = sut.numbers(sut.control_answers(control))
    lim = registry.load_limits(CELL)
    _assert_sound()
    assert any(nums[k] > lim[k] for k in lim), (control, nums, lim)


def test_step_returning_its_state_unchanged(monkeypatch):
    """A leapfrog step that leaves its wavefields as they were: the wave never
    leaves the source, and the step check reads its input back."""
    from repro_torch.core import wave

    def frozen(u, w, c, **kw):
        return w.copy_(u)

    monkeypatch.setattr(wave, "wave_leapfrog", frozen)
    res = _run()
    monkeypatch.undo()
    _assert_sound()
    assert res["correct"] is False
    for k in ("u_gap", "step_gap"):
        assert res["check"][k]["value"] > res["check"][k]["limit"]


def test_answer_altered_where_produced():
    def wrap(propagate):
        def altered(source, steps, **fields):
            res = propagate(source, steps, **fields)
            u = res.u.clone()
            flat = u.view(-1)
            flat[flat.numel() // 2] += u.abs().max()
            return dataclasses.replace(res, u=u)
        return altered

    _assert_sound()
    res = _run(wrap)
    assert res["correct"] is False and res["failed"] == 0


def test_answer_not_a_number():
    """A NaN in an answer reads as an infinite gap, not as no gap."""
    def wrap(propagate):
        def nan(source, steps, **fields):
            res = propagate(source, steps, **fields)
            u = res.u.clone()
            u.view(-1)[0] = float("nan")
            return dataclasses.replace(res, u=u)
        return nan

    _assert_sound()
    res = _run(wrap)
    assert res["correct"] is False
    assert res["check"]["u_gap"]["value"] == math.inf
    assert res["check"]["step_gap"]["value"] == math.inf


def test_program_without_the_stepper_fails_at_once(monkeypatch):
    """The parent commit has no ``repro_torch.core.wave``: the cell's set-up
    raises before it makes any input."""
    import repro_torch.core

    monkeypatch.setitem(sys.modules, "repro_torch.core.wave", None)
    monkeypatch.delattr(repro_torch.core, "wave", raising=False)
    with pytest.raises(ImportError):
        wave_shots.System(CONFIG, _traffic(), SEED, "cpu")


def test_step_bytes_four_words_a_point():
    """Read u^n, u^{n-1} and c, write u^{n+1}: 16 B a point; 12.0 GB a step at
    755x994x1000, 3.58 ms at 3.35 TB/s."""
    assert leapfrog_roofline.step_bytes(8 * 6 * 5) == 4 * 240 * 4
    b = leapfrog_roofline.step_bytes(755 * 994 * 1000)
    assert b == 16 * 750_470_000 == 12_007_520_000
    assert b / 3.35e12 == pytest.approx(3.584e-3, abs=5e-7)
    assert W["chips"] == 1 and registry.load_traffic(W["traffic"])["mesh"] == [755, 994, 1000]


def test_rooflines_read_the_stretch():
    op = types.SimpleNamespace
    kern = [op(base="wave_leapfrog_kernel", seconds=2e-3), op(base="other", seconds=1.0)]
    run = op(device_kind="NVIDIA H100 80GB HBM3", facts=dict(points=10**8, itemsize=4),
             stretch=op(kernels=kern, window_s=0.5), stretch_iterations=100)
    assert leapfrog_roofline.read(run) == pytest.approx(1.6e9 / 3.35e12 / 2e-3 * 100)
    assert step_roofline.read(run) == pytest.approx(1.6e9 / 3.35e12 / 5e-3 * 100)
    assert leapfrog_roofline.read(op(**{**vars(run), "device_kind": "cpu"})) is None


def test_traced_run_reports_the_span_metric_and_refuses_a_mismatch(monkeypatch):
    from repro_torch.obs import trace

    trace.reset()
    res = _run(traced=True)
    events = trace.events()
    shots = sum(e["name"] == "wave.shot" for e in events)
    steps = sum(e["name"] == "wave.step" for e in events)
    assert shots > 0 and steps == 200 * shots
    value = res["metrics"]["shot_host_ms"]["value"]
    assert math.isfinite(value) and value > 0
    reader = registry.metric("shot_host_ms")
    monkeypatch.setattr(trace, "events", lambda: list(events))
    run = types.SimpleNamespace(stretch_solves=[None] * shots, stretch_iterations=steps)
    assert reader.read(run) == value
    assert reader.read(types.SimpleNamespace(stretch_solves=[None] * (shots + 1),
                                             stretch_iterations=steps)) is None
    assert reader.read(types.SimpleNamespace(stretch_solves=[None] * shots,
                                             stretch_iterations=steps - 1)) is None


def test_sources_from_the_seed():
    shape = (755, 994, 1000)
    for seed in (0, 2**31 + 3, 2**40 + 9):
        srcs, near = wave_shots.shot_sources(shape, 4, 10, seed)
        assert srcs == wave_shots.shot_sources(shape, 4, 10, seed)[0]
        for k, (x, y, z) in enumerate(srcs):
            assert z == 10
            inner = [n // 4 <= p < n - n // 4 for p, n in zip((x, y), shape)]
            if k == near:
                assert min(x, shape[0] - 1 - x) < 4 or min(y, shape[1] - 1 - y) < 4
            else:
                assert all(inner)
    sut = wave_shots.System(CONFIG, _traffic(), SEED, "cpu")
    assert sut.near_face in sut.checked and len(sut.checked) == 2


def test_boxed_and_slabbed_reference_equals_the_whole_grid(monkeypatch):
    """The reference's shot steps only the box where the result can be
    nonzero, in x-slabs: the same bits as every step on the whole grid in
    one slab."""
    shape = (26, 22, 30)
    op = registry.operator(CONFIG["operator"]["kind"])
    c = op.c_of(op.velocity(shape, CONFIG["operator"]["params"], 5, "cpu"),
                CONFIG["operator"]["params"])
    samples = ref_wave.ricker(50, 8e-4, 10.0, 0.1)
    src = (2, 11, 9)
    boxed = ref_wave.shot(c, src, samples, 50)
    monkeypatch.setattr(ref_wave, "SLAB_POINTS", 5 * 22 * 30)
    slabbed = ref_wave.shot(c, src, samples, 50)
    u, w = torch.zeros(shape), torch.zeros(shape)
    whole = tuple((0, n) for n in shape)
    for n in range(50):
        ref_wave.step_into(u, w, c, whole, source=src, term=float(c[src]) * samples[n])
        u, w = w, u
    assert torch.equal(boxed, u) and torch.equal(slabbed, u)
    assert float(u.abs().max()) > 1e-3


def test_reference_holds_the_ports_plain_path():
    """The port's shot against the reference on the benchmark's own medium:
    apart by rounding only (the two sum the taps in different orders)."""
    from repro_torch.core import wave

    shape = (24, 20, 28)
    params = CONFIG["operator"]["params"]
    op = registry.operator(CONFIG["operator"]["kind"])
    v = op.velocity(shape, params, 9, "cpu")
    model = wave.WaveModel.from_velocity(v, dt=params["dt_s"], h=params["h_m"])
    got = wave.propagate_shot(model, (12, 10, 10), wave.Ricker(10.0, 0.1), 60).u
    want = ref_wave.shot(op.c_of(v, params), (12, 10, 10),
                         ref_wave.ricker(60, params["dt_s"], 10.0, 0.1), 60)
    gap = float((got - want).norm() / want.norm())
    assert gap < 1e-5
