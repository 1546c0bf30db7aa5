"""The block cell ``momentum_star7.uvw_paper_mesh`` driven through
``harness.run_cell`` on the CPU at a small mesh, under the cell's own
limits: a sound run is correct; a Krylov step that returns its state
unchanged, a fault or a NaN planted in one component of the block's
answer, or a component missing, makes it not correct; the control,
the segregated reference in the precision below the configuration's put in
the program's place, fails the limits.
"""

import dataclasses
import functools

import pytest

from perfbench import harness, registry

MANIFEST = registry.load_manifest()
CELL = "momentum_star7.uvw_paper_mesh"
#: the paper mesh cells' test mesh (``test_perfbench_faults.py``)
MESH = [24, 24, 32]
SEED = 2**31 + 17


def _run(wrap=None, traced=False):
    return harness.run_cell(MANIFEST, CELL, seed=SEED, seconds=0.3, traced=traced,
                            device="cpu", t_start=0.0, wrap=wrap,
                            traffic_override={"mesh": MESH})[0]


@functools.cache
def _sound():
    return _run(traced=True)


def test_sound_run_is_correct():
    res = _sound()
    assert res["correct"] is True and res["failed"] == 0, res["check"]
    assert res["attempted"] > 0 and set(res["check"]) >= {"x_gap", "x_gap_max", "res_ratio"}
    # the block metrics of the card stay silent on the CPU: no card, no launch
    assert set(res["metrics"]) <= {"block_plain_ms_per_iter"}


def _altered(component):
    def wrap(solve):
        def altered(b):
            res = solve(b)
            x = res.x.clone()
            flat = x[component].view(-1)
            flat[flat.numel() // 2] += x[component].abs().max()
            return dataclasses.replace(res, x=x)
        return altered
    return wrap


@pytest.mark.parametrize("component", [0, 2])
def test_a_fault_in_one_component_is_not_correct(component):
    assert _sound()["correct"] is True
    res = _run(_altered(component))
    assert res["correct"] is False and res["failed"] == 0
    assert res["check"]["x_gap_max"]["value"] > res["check"]["x_gap_max"]["limit"]


def test_step_returning_its_state_unchanged(monkeypatch):
    from repro_torch.core.solvers import bicgstab

    run = bicgstab.run_krylov

    def frozen(step, init, **kw):
        return run(lambda c: (c[0] + 1,) + tuple(c[1:]), init, **kw)

    monkeypatch.setattr(bicgstab, "run_krylov", frozen)
    res = _run()
    monkeypatch.undo()
    assert _sound()["correct"] is True
    assert res["correct"] is False
    assert res["check"]["x_gap"]["value"] > res["check"]["x_gap"]["limit"]


def test_a_nan_in_one_component_reads_as_an_infinite_gap():
    def wrap(solve):
        def nan(b):
            res = solve(b)
            x = res.x.clone()
            x[1].view(-1)[0] = float("nan")
            return dataclasses.replace(res, x=x)
        return nan

    assert _sound()["correct"] is True
    res = _run(wrap)
    assert res["correct"] is False
    assert res["check"]["x_gap"]["value"] == float("inf")


def test_a_missing_component_is_not_correct():
    def wrap(solve):
        def two(b):
            res = solve(b)
            return dataclasses.replace(res, x=res.x[:2], iterations=res.iterations[:2],
                                       rel_residual=res.rel_residual[:2],
                                       breakdown=res.breakdown[:2])
        return two

    assert _sound()["correct"] is True
    res = _run(wrap)
    assert res["correct"] is False and res["failed"] > 0
    assert res["check"]["x_gap"]["value"] == float("inf")


def test_control_fails():
    w = registry.workload(MANIFEST, CELL)
    config = registry.load_config(MANIFEST, w["config"])
    traffic = dict(registry.load_traffic(w["traffic"]), mesh=MESH)
    sut = registry.system(config["system"]).System(config, traffic, SEED, "cpu")
    nums = sut.numbers(sut.control_answers())
    lim = registry.load_limits(CELL)
    assert _sound()["correct"] is True
    assert any(nums[k] > lim[k] for k in lim), (nums, lim)


def test_facts_carry_the_block():
    w = registry.workload(MANIFEST, CELL)
    config = registry.load_config(MANIFEST, w["config"])
    traffic = dict(registry.load_traffic(w["traffic"]), mesh=MESH)
    sut = registry.system(config["system"]).System(config, traffic, SEED, "cpu")
    assert tuple(sut.pool[0].shape) == (3, *MESH) and len(sut.pool) == 2
    assert len(sut.checked) == 1
    rec = sut.step(0)
    assert rec.iterations == 6 and not rec.failed
    facts = sut.facts()
    assert facts["nrhs"] == 3 and facts["points"] == 24 * 24 * 32 and facts["itemsize"] == 2
