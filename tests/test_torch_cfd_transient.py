"""The port's transient, checkpointed SIMPLE driver: against the JAX
package's ``run_transient``, and the port's own restart invariants (a
checkpointed run, a resumed run and a run with an injected fault each equal
the uninterrupted run bit for bit), the channel's mass balance and the
runner's restart budget."""

import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.apps.cfd as J  # noqa: E402
import repro_torch.apps.cfd as T  # noqa: E402
from _torch_port import to_np  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402


def _gap(a, b) -> float:
    return float(np.abs(to_np(a).astype(np.float64) - to_np(b)).max())


@pytest.mark.parametrize("scenario", ["cavity", "channel"])
def test_short_transient_matches_reference(scenario):
    """2 steps of dt 0.05 x 3 outer iterations from rest, n=12.  The first
    steps of an impulsive start run the truncated inner solves far from
    convergence, where they amplify rounding: the reference's own jitted
    and op-by-op runs differ far beyond f32 rounding, most in the channel.
    Each field of the port is held within max(1e-5, 10 x that gap) of the
    jitted reference, and the per-step metrics likewise."""
    kw = dict(n=12, reynolds=100.0 if scenario == "cavity" else 50.0, scenario=scenario)
    tk = dict(dt=0.05, n_steps=2, outers_per_step=3)
    ref, ref_m = J.run_transient(J.CFDConfig(**kw), J.TransientConfig(**tk))
    with jax.disable_jit():
        eager, eager_m = J.run_transient(J.CFDConfig(**kw), J.TransientConfig(**tk))
    port, port_m = T.run_transient(T.CFDConfig(**kw), T.TransientConfig(**tk), device="cpu")
    for a, b, e in zip(port, ref, eager):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _gap(a, b) <= max(1e-5, 10 * _gap(e, b)), (_gap(a, b), _gap(e, b))
    assert [m["step"] for m in port_m] == [m["step"] for m in ref_m] == [0, 1]
    for pm, rm, em in zip(port_m, ref_m, eager_m):
        for k in ("continuity", "mom_res_u"):
            assert abs(pm[k] - rm[k]) <= max(1e-5 * abs(rm[k]), 10 * abs(em[k] - rm[k]))


def _cfgs():
    return T.CFDConfig(n=12, reynolds=100.0), T.TransientConfig(
        dt=0.05, n_steps=6, outers_per_step=5, checkpoint_every=2)


@pytest.fixture(scope="module")
def uninterrupted():
    cfg, tcfg = _cfgs()
    return T.run_transient(cfg, tcfg, device="cpu")


def _same_state(a, b) -> None:
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_checkpointed_run_equals_uninterrupted_bitwise(uninterrupted, tmp_path,
                                                       async_checkpoint):
    cfg, tcfg = _cfgs()
    tcfg.async_checkpoint = async_checkpoint
    state, metrics_ = T.run_transient(cfg, tcfg, checkpoint_dir=str(tmp_path), device="cpu")
    assert len(metrics_) == tcfg.n_steps
    assert any(f.endswith(".npz") for f in os.listdir(tmp_path))
    _same_state(state, uninterrupted[0])
    assert metrics_ == uninterrupted[1]


def test_replay_after_injected_fault_is_bitwise(uninterrupted, tmp_path):
    """Step 3 is not a checkpoint boundary (checkpoints land at 2, 4, 6):
    the replay re-runs steps 2-3, and the metrics keep one entry per step."""
    cfg, tcfg = _cfgs()
    armed = {"v": True}

    def hook(step):
        if step == 3 and armed["v"]:
            armed["v"] = False
            raise RuntimeError("injected fault")

    metrics.reset()
    state, metrics_ = T.run_transient(cfg, tcfg, checkpoint_dir=str(tmp_path),
                                      failure_hook=hook, device="cpu")
    assert not armed["v"], "fault was never injected"
    assert [m["step"] for m in metrics_] == list(range(tcfg.n_steps))
    _same_state(state, uninterrupted[0])
    assert metrics_ == uninterrupted[1]
    assert metrics.snapshot()["counters"]["runner.restarts"] == 1
    restarts = [e for e in metrics.events() if e["event"] == "runner_restart"]
    assert len(restarts) == 1 and "injected fault" in restarts[0]["error"]


def test_resume_from_the_latest_checkpoint_is_bitwise(uninterrupted, tmp_path):
    """A run stopped after 4 steps and started again for 6 in the same
    directory resumes at step 4 and ends on the uninterrupted state."""
    cfg, tcfg = _cfgs()
    tcfg.n_steps = 4
    T.run_transient(cfg, tcfg, checkpoint_dir=str(tmp_path), device="cpu")
    tcfg.n_steps = 6
    state, metrics_ = T.run_transient(cfg, tcfg, checkpoint_dir=str(tmp_path), device="cpu")
    assert [m["step"] for m in metrics_] == [4, 5]
    _same_state(state, uninterrupted[0])


def test_restart_budget_surfaces_the_failure(tmp_path):
    cfg, tcfg = _cfgs()
    tcfg.n_steps, tcfg.max_restarts = 2, 2

    def always(step):
        raise RuntimeError("the card fell off the bus")

    with pytest.raises(RuntimeError, match="exceeded restart budget"):
        T.run_transient(cfg, tcfg, checkpoint_dir=str(tmp_path), failure_hook=always,
                        device="cpu")


def test_channel_conserves_mass_and_develops():
    """The reference's channel check on the port: outlet flux equal to the
    inflow to 1e-5, a developing profile, v = 0 at the top wall."""
    cfg = T.CFDConfig(n=12, reynolds=50.0, scenario="channel", u_in=1.0)
    tcfg = T.TransientConfig(dt=0.05, n_steps=5, outers_per_step=8)
    (u, v, p), metrics_ = T.run_transient(cfg, tcfg, device="cpu")
    h = 1.0 / cfg.n
    assert float(u[-1, :].sum() * h) == pytest.approx(cfg.u_in, abs=1e-5)
    profile = to_np(u[-1, :])
    assert profile[cfg.n // 2] > 1.1 * profile[0]
    assert float(v[:, -1].abs().max()) == 0.0
    assert metrics_[-1]["continuity"] < 1e-3
