"""A checkpointed transient CFD march across ranks (``apps/cfd/driver.py``,
``runtime/runner.py``, ``checkpoint/manager.py``, ``launch/cfd.py``) on four
gloo ranks on the CPU, a 2x2 fabric: the n = 12 cavity, dt 0.05, 6 steps of
3 outer iterations, spmd, a checkpoint every 2 steps.

* A fault injected on rank 1 alone at step 3 (not a checkpoint boundary)
  sends every rank back to step 2 together (one ``all_reduce_max`` flag per
  step), and the replay equals the uninterrupted 2x2 march bit for bit, its
  metrics included, on every rank; rank 0 alone wrote the checkpoints.
* A march stopped after 4 steps and run again for 6 in the same directory
  resumes at step 4 on every rank and ends on the uninterrupted state; so
  does ``python -m repro_torch.launch.cfd`` under ranks run again with more
  ``--steps``.
* The checkpoint the ranks wrote restores bit for bit in a one-rank port
  run (which resumes from it) and in the JAX package's
  ``CheckpointManager``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import run_with_ranks  # noqa: E402

N, STEPS, EVERY = 12, 6, 2

PORT = """
import json, os, numpy as np, torch
from repro_torch.apps.cfd import CFDConfig, SolverOptions, TransientConfig, run_transient
from repro_torch.launch import cfd as cli
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.obs import metrics
N, STEPS, EVERY, TMP = %r, %r, %r, %r
mesh = make_mesh_for_devices(4)
cfg, opts = CFDConfig(n=N, reynolds=100.0), SolverOptions(backend="spmd")
def tcfg(steps):
    return TransientConfig(dt=0.05, n_steps=steps, outers_per_step=3, checkpoint_every=EVERY)
def march(steps, **kw):
    return run_transient(cfg, tcfg(steps), opts, mesh, device="cpu", **kw)
def same(a, b):
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

ref, ref_m = march(STEPS)
armed = {"v": RANK == 1}
def hook(step):
    if step == 3 and armed["v"]:
        armed["v"] = False
        raise RuntimeError("injected fault")
metrics.reset()
state, m = march(STEPS, checkpoint_dir=os.path.join(TMP, "fault"), failure_hook=hook)
snap = metrics.snapshot()["counters"]
info = dict(fault_equal=same(state, ref), metrics_equal=m == ref_m, steps=[r["step"] for r in m],
            restarts=snap.get("runner.restarts", 0), saves=snap.get("checkpoint.saves", 0),
            restores=snap.get("checkpoint.restores", 0),
            errors=[e["error"] for e in metrics.events() if e["event"] == "runner_restart"])
march(4, checkpoint_dir=os.path.join(TMP, "resume"))
state, m = march(STEPS, checkpoint_dir=os.path.join(TMP, "resume"))
info.update(resume_equal=same(state, ref), resume_steps=[r["step"] for r in m])
argv = ["--device", "cpu", "--scenario", "cavity", "--n", str(N), "--backend", "spmd",
        "--dt", "0.05", "--outers-per-step", "3", "--checkpoint-dir", os.path.join(TMP, "cli")]
first = cli.main(argv + ["--steps", "2"])
again = cli.main(argv + ["--steps", "4"])
info.update(cli_steps=[first["steps"], again["steps"]])
print(json.dumps(info))
if RANK == 0:
    np.savez(os.path.join(TMP, "ref.npz"), *[t.numpy() for t in ref])
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_ckpt")
    outs = run_with_ranks(PORT % (N, STEPS, EVERY, str(tmp)), 4, tmp)
    ref = np.load(tmp / "ref.npz")
    return [json.loads(o.strip().splitlines()[-1]) for o in outs], [
        ref[f"arr_{i}"] for i in range(3)], tmp


def test_fault_on_one_rank_replays_bitwise(runs):
    infos, _, tmp = runs
    for rank, info in enumerate(infos):
        assert info["fault_equal"] and info["metrics_equal"], rank
        assert info["steps"] == list(range(STEPS)), rank
        # rank 0 reads the checkpoint and hands it to the others
        assert info["restarts"] == 1 and info["restores"] == int(rank == 0), rank
        want = "injected fault" if rank == 1 else "failed on another rank"
        assert len(info["errors"]) == 1 and want in info["errors"][0], (rank, info["errors"])
    # rank 0 alone writes: the checkpoints at 2, 4, 6 and the final save at 6
    assert [i["saves"] for i in infos] == [STEPS // EVERY + 1, 0, 0, 0]
    assert sorted(os.listdir(tmp / "fault")) == [
        f"step_{s:09d}.{ext}" for s in (2, 4, 6) for ext in ("json", "npz")]


def test_rerun_resumes_from_the_latest_step_on_every_rank(runs):
    infos, _, _ = runs
    for info in infos:
        assert info["resume_equal"] and info["resume_steps"] == [4, 5]
        assert info["cli_steps"] == [2, 2]


def test_rank_checkpoint_restores_in_one_rank_port_and_in_jax(runs):
    from _torch_port import assert_bitwise, to_t
    from repro.checkpoint import CheckpointManager as JaxManager
    from repro_torch.apps.cfd import CFDConfig, TransientConfig, run_transient
    from repro_torch.checkpoint import CheckpointManager

    _, ref, tmp = runs
    d = str(tmp / "fault")
    like = tuple(torch.zeros(a.shape) for a in ref)
    (state, _), step = CheckpointManager(d).restore_latest((like, ()))
    assert step == STEPS
    for got, want in zip(state, ref):
        assert_bitwise(got, want)
    jlike = tuple(np.zeros(a.shape, np.float32) for a in ref)
    (jstate, _), jstep = JaxManager(d).restore_latest((jlike, ()))
    assert jstep == STEPS
    for got, want in zip(jstate, ref):
        assert_bitwise(to_t(got), want)
    # a one-rank march resumes from the ranks' checkpoint at the next step
    _, m = run_transient(CFDConfig(n=N, reynolds=100.0), TransientConfig(
        dt=0.05, n_steps=STEPS + 1, outers_per_step=3, checkpoint_every=EVERY),
        checkpoint_dir=d, device="cpu")
    assert [r["step"] for r in m] == [STEPS]


class _Steps:
    def iterate(self, start_step):
        s = start_step
        while True:
            yield s, None
            s += 1


def test_a_fault_inside_the_step_on_one_rank_ends_the_run(tmp_path, monkeypatch):
    """Across ranks an exception raised inside the step on one rank leaves
    its peers in the step's collectives, so the runner ends the run with
    ``StepFaultAcrossRanks`` instead of sending that rank into a restore;
    a rank other than 0 writes no checkpoint.  Rank 1 of 2 is faked in one
    process, with the collectives the identity and rank 0 holding no
    checkpoint."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import runner as rmod

    for name, fn in (("world_size", lambda: 2), ("rank", lambda: 1),
                     ("is_root", lambda: False), ("all_reduce_max", lambda t: t),
                     ("broadcast_object", lambda obj: None)):
        monkeypatch.setattr(rmod.dist, name, fn)

    def train_step(params, opt_state, batch):
        if float(params[0]) == 2.0:
            raise RuntimeError("device fault")
        return params + 1, opt_state, {}

    runner = rmod.FaultTolerantRunner(
        rmod.RunnerConfig(total_steps=4, checkpoint_every=1, async_checkpoint=False),
        train_step=train_step, data=_Steps(), ckpt=CheckpointManager(str(tmp_path)))
    with pytest.raises(rmod.StepFaultAcrossRanks, match="step 2 raised on rank 1") as err:
        runner.run(torch.zeros(1), ())
    assert "device fault" in str(err.value.__cause__)
    assert runner.restarts == 0 and os.listdir(tmp_path) == []
