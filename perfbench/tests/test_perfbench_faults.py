"""A run with the timed path broken underneath comes out not correct, and
the same run unbroken comes out correct.

Each test skips the harness's look for a card and drives the rest of a run
(set-up, window, check) on the CPU at a small mesh, under the cell's own
limits, with one fault planted in the program or in what it returns: a
Krylov step that returns its state unchanged; an answer altered where it is
produced; a NaN in an answer.  Beside each fault the same run unbroken, at
the same mesh and seed, is correct.  The control, the reference in the
precision below the configuration's put in the program's place, fails each
cell's limits too.
"""

import dataclasses
import functools

import pytest

from perfbench import harness, registry

MANIFEST = registry.load_manifest()
#: test meshes at which a sound run is correct under the cells' limits: at 12-16 points
#: an edge, 6 iterations already pass the plateau, and the CPU's plain path parts from
#: the reference on some seeds
SMALL = {"cs1_star7.paper_mesh": [24, 24, 32], "cs1_star7.joule600": [20, 18, 24]}
SEED = 2**31 + 17
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _run(cell, wrap=None):
    return harness.run_cell(MANIFEST, cell, seed=SEED, seconds=0.3, traced=False,
                            device="cpu", t_start=0.0, wrap=wrap,
                            traffic_override={"mesh": SMALL[cell]})[0]


@functools.cache
def _sound(cell):
    return _run(cell)


def _assert_sound(cell):
    res = _sound(cell)
    assert res["correct"] is True and res["failed"] == 0, res["check"]
    assert res["attempted"] > 0 and set(res["check"]) >= {"x_gap", "res_ratio"}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    _assert_sound(cell)


@pytest.mark.parametrize("cell", CELLS)
def test_step_returning_its_state_unchanged(cell, monkeypatch):
    from repro_torch.core.solvers import bicgstab

    run = bicgstab.run_krylov

    def frozen(step, init, **kw):
        return run(lambda c: (c[0] + 1,) + tuple(c[1:]), init, **kw)

    monkeypatch.setattr(bicgstab, "run_krylov", frozen)
    res = _run(cell)
    monkeypatch.undo()
    _assert_sound(cell)
    assert res["correct"] is False
    assert res["check"]["x_gap"]["value"] > res["check"]["x_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell):
    def wrap(solve):
        def altered(b):
            res = solve(b)
            x = res.x.clone()
            flat = x.view(-1)
            flat[flat.numel() // 2] += x.abs().max()
            return dataclasses.replace(res, x=x)
        return altered

    _assert_sound(cell)
    res = _run(cell, wrap)
    assert res["correct"] is False and res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_answer_not_a_number(cell):
    """A NaN in an answer reads as an infinite gap, not as no gap."""
    def wrap(solve):
        def nan(b):
            res = solve(b)
            x = res.x.clone()
            x.view(-1)[0] = float("nan")
            return dataclasses.replace(res, x=x)
        return nan

    _assert_sound(cell)
    res = _run(cell, wrap)
    assert res["correct"] is False
    assert res["check"]["x_gap"]["value"] == float("inf")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    w = registry.workload(MANIFEST, cell)
    config = registry.load_config(MANIFEST, w["config"])
    traffic = dict(registry.load_traffic(w["traffic"]), mesh=SMALL[cell])
    sut = registry.system(config["system"]).System(config, traffic, SEED, "cpu")
    nums = sut.numbers(sut.control_answers())
    lim = registry.load_limits(cell)
    _assert_sound(cell)
    assert any(nums[k] > lim[k] for k in lim), (nums, lim)
