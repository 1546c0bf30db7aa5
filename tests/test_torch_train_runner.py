"""Training through the port's fault-tolerant runner and ``launch/train``,
on the CPU at smoke width, in the configs' own bf16.

* A failure injected after a checkpoint replays from it, and one injected
  before the first checkpoint from the initial state: either way the final
  parameters, moments and every metric equal an unfaulted run's, bit for
  bit (the step is functional, so the runner's initial state stays intact).
* The training state (parameters and ``AdamWState``) checkpoints in the JAX
  package's format: the port's checkpoint restores there leaf for leaf,
  with the same bits.
* ``python -m repro_torch.launch.train --ckpt-dir`` resumes from the latest
  checkpoint: a run stopped at step 4 and restarted ends on the same
  checkpoint, bit for bit, as one uninterrupted run.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_port import run_python  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch.train import build, make_stepper  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import FaultTolerantRunner, RunnerConfig  # noqa: E402

ARCH, STEPS, EVERY = "qwen2_moe_a2_7b", 8, 3


def _run(tmp, fail_at: int | None):
    cfg, data = build(ARCH, seq_len=16, global_batch=2)
    dev = torch.device("cpu")
    params = TM.init_train_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = adamw_init(params)
    armed = {"on": fail_at is not None}

    def hook(step):
        if armed["on"] and step == fail_at:
            armed["on"] = False
            raise RuntimeError("injected fault")

    runner = FaultTolerantRunner(
        RunnerConfig(total_steps=STEPS, checkpoint_every=EVERY),
        train_step=make_stepper(cfg, dev, total_steps=STEPS), data=data,
        ckpt=CheckpointManager(str(tmp)), failure_hook=hook)
    p, o = runner.run(params, opt)
    return p, o, runner


@pytest.mark.parametrize("fail_at", [4, 1], ids=["after_checkpoint", "before_checkpoint"])
def test_replay_after_injected_failure_is_bitwise(tmp_path, fail_at):
    p0, o0, r0 = _run(tmp_path / "clean", None)
    p1, o1, r1 = _run(tmp_path / "fault", fail_at)
    assert r0.restarts == 0 and r1.restarts == 1
    a, b = tree_leaves((p0, o0)), tree_leaves((p1, o1))
    assert [k for k, _ in a] == [k for k, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    clean = {m["step"]: m for m in r0.metrics_history}
    assert sorted(clean) == list(range(STEPS))
    for m in r1.metrics_history:          # replayed steps included
        assert m == clean[m["step"]], (m, clean[m["step"]])
    replayed = len(r1.metrics_history) - STEPS
    assert replayed == (fail_at - (fail_at // EVERY) * EVERY)
    assert int(o1.count) == STEPS


def test_training_checkpoint_restores_in_the_jax_package(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import CheckpointManager as JCkpt
    from repro.configs import get_smoke as jget
    from repro.models import model as JM
    from repro.optim.adamw import adamw_init as jadamw_init

    p, o, _ = _run(tmp_path / "port", None)
    jc = jget(ARCH)
    like = jax.eval_shape(lambda: (JM.init_params(jc, jax.random.PRNGKey(0)),
                                   jadamw_init(JM.init_params(jc, jax.random.PRNGKey(0)))))
    like = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), like)
    (jp, jo), step = JCkpt(str(tmp_path / "port")).restore_latest(like)
    assert step == STEPS and int(jo.count) == STEPS
    want = tree_leaves((p, o))
    got = tree_leaves(jax.tree.map(np.asarray, (jp, jo)))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        w = w.detach()
        if w.dtype == torch.bfloat16:
            w = w.view(torch.int16).numpy()
            g = np.asarray(g).view(np.int16)
        else:
            w = w.numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), k


def _cli(*args: str) -> dict:
    res = run_python(f"""
        from repro_torch.launch.train import main
        main({list(args)!r})
    """, env_extra={"OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith(f"arch={ARCH}_smoke params=") and "devices=1 (cpu)" in lines[0]
    assert lines[-2].startswith("done: ")
    return json.loads(lines[-1])


def test_launch_train_resumes_from_its_checkpoint(tmp_path):
    common = ["--device", "cpu", "--arch", ARCH, "--seq", "16", "--batch", "2",
              "--steps", "6", "--ckpt-every", "2"]
    whole = _cli(*common, "--ckpt-dir", str(tmp_path / "whole"))
    assert whole["steps"] == list(range(6)) and len(whole["step_ms"]) == 6
    assert not any(whole["kernel_launches"].values())
    assert whole["peak_memory_gb"] is None
    # a run that stopped after its step-4 checkpoint: restart it
    stopped = tmp_path / "stopped"
    stopped.mkdir()
    for f in ("step_000000004.npz", "step_000000004.json"):
        shutil.copy(tmp_path / "whole" / f, stopped / f)
    resumed = _cli(*common, "--ckpt-dir", str(stopped))
    assert resumed["steps"] == [4, 5]
    assert resumed["losses"] == whole["losses"][4:]
    a, b = (np.load(d / "step_000000006.npz") for d in (tmp_path / "whole", stopped))
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    assert os.path.exists(stopped / "step_000000006.json")


def test_launch_train_without_checkpoints_logs_the_reference_lines():
    out = _cli("--device", "cpu", "--arch", ARCH, "--seq", "16", "--batch", "2",
               "--steps", "3", "--log-every", "1")
    assert out["steps"] == [0, 1, 2] and all(np.isfinite(out["losses"]))
