"""Training across four gloo ranks (``runtime/sharded.py``, 2 x 2) against the
JAX package's sharded step on four fake devices (2 x 2, GSPMD: parameters
placed by ``param_shardings``, moments by ZeRO-1 ``out_shardings_for_train``,
the batch over ``data``), and against the port's one-rank step of the
global batch, in f32, for two steps:

* ``qwen2_1_5b``'s smoke config, 4 x 32 tokens with a loss mask;
* ``qwen2_moe_a2_7b``'s, 4 x 64 tokens with a loss mask: the load-balancing
  loss is a product of two global means, and its token groups (16) fall
  inside one rank's shard;
* the same with ``moe_group_size`` 256: one token group of 256 spans both
  data shards, so the capacity (of a 256-token group) and the positions in
  each expert's buffer come from the whole group, across the ranks.

Both packages start from the same weights (numpy, from a seed) and take the
same batches.  Tolerances (``tests/_torch_train.py``'s): the first step's
losses within ``LOSS_ULPS`` f32 ulps of the reference's and the one-rank
step's, the second's within twice that of the one-rank step's (its
parameters already differ by the first step's flips); the parameters after
each step within the flip bound summed over the steps, ``2 sum(lr) + 4``
ulps of |p|; the first step's moments within the gradient tolerance of
their leaf's largest (mu; nu twice it).  Each rank's blocks have its spec's
shapes and bytes, and ranks that hold the same block hold the same bits.

Then the runner across the ranks: a sharded checkpointed run with a fault
injected on rank 1 replays bit for bit; its checkpoint (the full tree,
written by rank 0) restores in a one-rank run, and a one-rank run's
checkpoint restores into every rank's blocks.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from _torch_port import finish, run_with_ranks, start_with_devices
from _torch_train import DEFAULT_GRAD_ULPS, LOSS_ULPS, leaf_ulps, scalar_ulps

torch.set_num_threads(1)

STEPS = 2
#: case -> (arch, global batch, tokens, config changes)
CASES = {"dense": ("qwen2_1_5b", 4, 32, {}),
         "moe": ("qwen2_moe_a2_7b", 4, 64, {}),
         "moe_spanning_group": ("qwen2_moe_a2_7b", 4, 64, {"moe_group_size": 256})}
RUNNER = dict(arch="qwen2_moe_a2_7b", seq=16, batch=4, steps=4, every=2, fault=3)


def _out() -> str:
    """Where the ranks write their records (set by the fixture)."""
    return os.environ["REPRO_TEST_RANKS_OUT"]


def port_config(case: str):
    from repro_torch.configs import get_smoke

    arch, _, _, change = CASES[case]
    return dataclasses.replace(get_smoke(arch), dtype=torch.float32, **change)


def numpy_params(cfg, seed: int = 0) -> dict:
    """Weights for both packages: each leaf of ``build_model_defs`` drawn
    from one numpy stream (f32; ones and zeros where the reference's
    initialiser puts them)."""
    from repro_torch.models import transformer
    from repro_torch.models.param import map_tree, tree_leaves

    rng = np.random.default_rng(seed)
    made = {}
    for path, d in tree_leaves(transformer.build_model_defs(cfg)):
        if d.init in ("zeros", "ones"):
            made[path] = np.full(d.shape, d.init == "ones", np.float32)
            continue
        fan_in = d.shape[0] if len(d.shape) == 1 else math.prod(d.shape[:-1])
        s = (1.0 / math.sqrt(d.shape[-1]) if d.init == "embed"
             else d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1)))
        made[path] = (s * rng.standard_normal(d.shape)).astype(np.float32)
    return map_tree(lambda path, _: made[path], transformer.build_model_defs(cfg),
                    with_path=True)


def batches(cfg, b: int, t: int) -> list[dict]:
    from _torch_train import make_batch

    return [make_batch(cfg, seed=10 + s, b=b, t=t) for s in range(STEPS)]


def _flat(prefix: str, tree) -> dict:
    from repro_torch.models.param import tree_leaves

    return {f"{prefix}/{k}": np.asarray(v, np.float32) for k, v in tree_leaves(tree)}


# ---------------------------------------------------------------------------
# The reference on four fake devices
# ---------------------------------------------------------------------------

JAX_CODE = """
import dataclasses, json, sys
import numpy as np
sys.path.insert(0, {tests!r})
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.configs import get_smoke
from repro.launch.mesh import make_mesh_for_devices
from repro.models import model as M
from repro.models.param import physical_spec, rule_overrides
from repro.optim.adamw import adamw_init
import test_torch_train_ranks as T

mesh = make_mesh_for_devices()
assert dict(mesh.shape) == {{"data": 2, "model": 2}}, mesh.shape
out = {{}}
for case, (arch, b, t, change) in T.CASES.items():
    cfg = dataclasses.replace(get_smoke(arch), dtype=jnp.float32, **change)
    params = jax.tree.map(jnp.asarray, T.numpy_params(T.port_config(case)))
    with set_mesh(mesh), rule_overrides(dict(cfg.rules)):
        ps, os_, _ = M.out_shardings_for_train(cfg, mesh)
        params = jax.device_put(params, ps)
        opt = jax.device_put(adamw_init(params), os_)
        step = jax.jit(M.make_train_step(cfg), out_shardings=M.out_shardings_for_train(cfg, mesh))
        for s, nb in enumerate(T.batches(T.port_config(case), b, t)):
            sh = {{k: NamedSharding(mesh, physical_spec(v.shape, ("batch",) + (None,) * (v.ndim - 1), mesh))
                  for k, v in nb.items()}}
            params, opt, m = step(params, opt, {{k: jax.device_put(jnp.asarray(v), sh[k])
                                                for k, v in nb.items()}})
            out.update(T._flat(f"{{case}}/{{s}}/params", jax.tree.map(np.asarray, params)))
            out.update(T._flat(f"{{case}}/{{s}}/mu", jax.tree.map(np.asarray, opt.mu)))
            out.update(T._flat(f"{{case}}/{{s}}/nu", jax.tree.map(np.asarray, opt.nu)))
            for k in ("loss", "aux_loss", "lr"):
                out[f"{{case}}/{{s}}/{{k}}"] = np.asarray(m[k], np.float64)
np.savez({path!r}, **out)
print("jax done")
"""


# ---------------------------------------------------------------------------
# The port on four gloo ranks
# ---------------------------------------------------------------------------

def _rank_cases() -> None:
    """Every case's two sharded steps on this rank: its blocks' shapes, the
    gathered parameters and moments after each step, the metrics."""
    from repro_torch.core import dist
    from repro_torch.launch.mesh import make_mesh_for_devices
    from _torch_train import port_batch
    from repro_torch.models.param import block_slices, tree_from_numpy, tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.sharded import ShardedLayout, make_sharded_train_step

    rank, out, meta = dist.rank(), {}, {}
    for case, (_, b, t, _) in CASES.items():
        cfg = port_config(case)
        mesh = make_mesh_for_devices()
        layout = ShardedLayout(cfg, mesh, b)
        full = tree_from_numpy(numpy_params(cfg), "cpu")
        params, opt = layout.local_state((full, adamw_init(full)))
        shapes = {}
        for k, blk in tree_leaves(params):
            want = tuple(s.stop - s.start for s in block_slices(
                tuple(dict(tree_leaves(full))[k].shape), layout.pspec[k], mesh))
            shapes[k] = [list(blk.shape), list(want), str(layout.pspec[k])]
        for k, blk in tree_leaves(opt.mu):
            want = tuple(s.stop - s.start for s in block_slices(
                tuple(dict(tree_leaves(full))[k].shape), layout.zspec[k], mesh))
            shapes["mu/" + k] = [list(blk.shape), list(want), str(layout.zspec[k])]
        meta[case] = dict(shapes=shapes, param_bytes=layout.stored_bytes(params),
                          moment_bytes=layout.stored_bytes((opt.mu, opt.nu)),
                          shard=layout.shard_index, metrics=[])
        step = make_sharded_train_step(cfg, layout)
        for s, nb in enumerate(batches(cfg, b, t)):
            params, opt, m = step(params, opt, port_batch(layout.batch_shard(nb)))
            meta[case]["metrics"].append({k: float(v) for k, v in m.items()})
            fp, fo = layout.full_state((params, opt))
            out.update(_flat(f"{case}/{s}/params", fp))
            out.update(_flat(f"{case}/{s}/mu", fo.mu))
            out.update(_flat(f"{case}/{s}/nu", fo.nu))
    np.savez(os.path.join(_out(), f"rank{rank}.npz"), **out)
    with open(os.path.join(_out(), f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    _rank_runner(rank)
    print("ok", rank)


def _runner_parts(layout_for, ckpt_dir: str, fault_rank: int | None):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import dist
    from repro_torch.launch.train import build, make_stepper
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import FaultTolerantRunner, RunnerConfig

    cfg, data = build(RUNNER["arch"], seq_len=RUNNER["seq"], global_batch=RUNNER["batch"])
    dev = torch.device("cpu")
    full = TM.init_train_params(cfg, torch.Generator().manual_seed(0), dev)
    layout = layout_for(cfg)
    state = (full, adamw_init(full))
    if layout is not None:
        state = layout.local_state(state)
    armed = {"on": fault_rank is not None}

    def hook(step):
        if armed["on"] and step == RUNNER["fault"] and dist.rank() == fault_rank:
            armed["on"] = False
            raise RuntimeError("injected fault")

    runner = FaultTolerantRunner(
        RunnerConfig(total_steps=RUNNER["steps"], checkpoint_every=RUNNER["every"]),
        train_step=make_stepper(cfg, dev, total_steps=RUNNER["steps"], layout=layout),
        data=data, ckpt=CheckpointManager(ckpt_dir), failure_hook=hook, layout=layout)
    return runner, state


def _rank_runner(rank: int) -> None:
    """The checkpointed sharded run, clean and with a fault on rank 1; then
    a restore of a one-rank run's checkpoint into this rank's blocks."""
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models.param import tree_leaves
    from repro_torch.runtime.sharded import ShardedLayout

    layout_for = lambda cfg: ShardedLayout(cfg, make_mesh_for_devices(), RUNNER["batch"])
    finals, hist = [], []
    for name, fault in (("clean", None), ("fault", 1)):
        runner, state = _runner_parts(layout_for, os.path.join(_out(), f"ckpt_{name}"), fault)
        finals.append(runner.run(*state))
        hist.append((runner.restarts, runner.metrics_history))
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(finals[0]),
                                                           tree_leaves(finals[1])))
    one = os.path.join(_out(), "one_rank_ckpt")
    runner, state = _runner_parts(layout_for, one, None)
    got = runner._restore_latest(state)
    want = layout_for(runner_cfg()).local_state(_load_full(one, state))
    restored = got is not None and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(got[0]), tree_leaves(want)))
    with open(os.path.join(_out(), f"runner{rank}.json"), "w") as f:
        json.dump(dict(replay_same_bits=same, restarts=[h[0] for h in hist],
                       clean=hist[0][1], fault=hist[1][1], one_rank_restored=restored,
                       restored_step=None if got is None else got[1]), f)


def runner_cfg():
    from repro_torch.launch.train import build

    return build(RUNNER["arch"], seq_len=RUNNER["seq"], global_batch=RUNNER["batch"])[0]


def _load_full(ckpt_dir: str, like_state):
    """The one-rank checkpoint's full state, read directly (no runner)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.optim import AdamWState
    from repro_torch.runtime.sharded import ShardedLayout

    lay = ShardedLayout(runner_cfg(), RankMesh(("data", "model"), (1, 1)), RUNNER["batch"])
    full, _ = CheckpointManager(ckpt_dir).restore_latest(lay.full_like(like_state))
    assert isinstance(full[1], AdamWState)
    return full


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (4 fake devices) and the port (4 gloo ranks), run at
    once; a one-rank run's checkpoint for the ranks to restore first."""
    tmp = tmp_path_factory.mktemp("train_ranks")
    ref_path = str(tmp / "jax.npz")
    proc = start_with_devices(JAX_CODE.format(tests=os.path.dirname(__file__), path=ref_path),
                              4)
    runner, state = _runner_parts(lambda cfg: None, str(tmp / "one_rank_ckpt"), None)
    runner.cfg = dataclasses.replace(runner.cfg, total_steps=RUNNER["every"])
    one_rank = runner.run(*state)
    os.environ["REPRO_TEST_RANKS_OUT"] = str(tmp)
    outs = run_with_ranks(_rank_cases, 4, tmp, timeout=300)
    assert [o.split()[:1] for o in outs] == [["ok"]] * 4, outs
    finish(proc, timeout=300)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    meta = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(4)]
    runner_recs = [json.loads((tmp / f"runner{r}.json").read_text()) for r in range(4)]
    return dict(tmp=tmp, ref=dict(np.load(ref_path)), ranks=ranks, meta=meta,
                runner=runner_recs, one_rank=one_rank)


def _one_rank(case: str):
    """The port's one-rank steps of the global batch (no mesh)."""
    from _torch_train import port_batch
    from repro_torch.models import model as TM
    from repro_torch.models.param import tree_from_numpy
    from repro_torch.optim import adamw_init

    cfg = port_config(case)
    _, b, t, _ = CASES[case]
    p = tree_from_numpy(numpy_params(cfg), "cpu")
    o = adamw_init(p)
    out, metrics = {}, []
    for s, nb in enumerate(batches(cfg, b, t)):
        p, o, m = TM.make_train_step(cfg)(p, o, port_batch(nb))
        metrics.append({k: float(v) for k, v in m.items()})
        out.update(_flat(f"{case}/{s}/params", p))
        out.update(_flat(f"{case}/{s}/mu", o.mu))
        out.update(_flat(f"{case}/{s}/nu", o.nu))
    return out, metrics


def _held(got: dict, want: dict, case: str, lrs: list[float], label: str) -> dict:
    """Parameters after each step within the summed flip bound, first
    step's moments within the gradient tolerance; returns the gaps seen."""
    seen = {}
    for s in range(STEPS):
        bound_lr = 2 * sum(lrs[:s + 1])
        worst = 0.0
        for key in [k for k in want if k.startswith(f"{case}/{s}/params/")]:
            w, g = want[key].astype(np.float64), got[key].astype(np.float64)
            assert g.shape == w.shape, key
            gap = np.abs(g - w)
            bound = bound_lr + 4 * np.spacing(np.abs(w).astype(np.float32)).astype(np.float64)
            assert (gap <= bound).all(), (label, key, float(gap.max()), bound_lr)
            worst = max(worst, float((gap / bound).max()))
        seen[f"step{s}_params_over_bound"] = worst
    pre = f"{case}/0/"
    for name, tol in (("mu", DEFAULT_GRAD_ULPS + 4), ("nu", 2 * DEFAULT_GRAD_ULPS + 4)):
        keys = [k for k in want if k.startswith(pre + name + "/")]
        u = leaf_ulps({k: got[k] for k in keys}, {k: want[k] for k in keys})
        seen[f"step0_{name}_ulps"] = max(u.values())
        assert seen[f"step0_{name}_ulps"] <= tol, (label, name, sorted(u.items(),
                                                                      key=lambda kv: -kv[1])[:3])
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_steps_match_the_references_on_four_devices(runs, case):
    ref, got = runs["ref"], runs["ranks"][0]
    metrics = runs["meta"][0][case]["metrics"]
    lrs = [float(ref[f"{case}/{s}/lr"]) for s in range(STEPS)]
    assert [m["lr"] for m in metrics] == lrs
    assert [int(m["grad_step"]) for m in metrics] == list(range(1, STEPS + 1))
    for k in ("loss", "aux_loss"):
        first = scalar_ulps(metrics[0][k], ref[f"{case}/0/{k}"]) if float(
            ref[f"{case}/0/{k}"]) else abs(metrics[0][k])
        assert first <= LOSS_ULPS, (case, k, metrics[0][k], float(ref[f"{case}/0/{k}"]))
    seen = _held(got, ref, case, lrs, "jax")
    print(case, seen, [m["loss"] for m in metrics])


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_steps_match_the_ports_one_rank_step(runs, case):
    want, metrics = _one_rank(case)
    got = runs["ranks"][0]
    lrs = [m["lr"] for m in metrics]
    mine = runs["meta"][0][case]["metrics"]
    for s in range(STEPS):
        for k in ("loss", "aux_loss", "total_loss"):
            if metrics[s][k]:
                assert scalar_ulps(mine[s][k], metrics[s][k]) <= LOSS_ULPS * (1 + s), (
                    case, s, k, mine[s][k], metrics[s][k])
    print(case, _held(got, want, case, lrs, "one rank"))


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_stores_its_blocks_and_replicas_agree(runs, case):
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import transformer
    from repro_torch.models.param import physical_spec, rule_overrides, tree_leaves

    cfg = port_config(case)
    metas = [m[case] for m in runs["meta"]]
    for r, meta in enumerate(metas):
        for k, (shape, want, _) in meta["shapes"].items():
            assert shape == want, (r, k)
    # stored bytes: the blocks' own, as roofline_model's est_params_bytes counts them
    mesh = RankMesh(("data", "model"), (2, 2))
    with rule_overrides(dict(cfg.rules)):
        est = 0
        for _, d in tree_leaves(transformer.build_model_defs(cfg)):
            split = math.prod({"data": 2, "model": 2}[a]
                              for a in physical_spec(d.shape, d.axes, mesh).mesh_axes())
            est += math.prod(d.shape) * 4 // split
    assert all(m["param_bytes"] == est for m in metas)
    full = sum(math.prod(d.shape) for _, d in tree_leaves(transformer.build_model_defs(cfg)))
    assert all(m["moment_bytes"] < 2 * 4 * full for m in metas)
    assert [m["shard"] for m in metas] == [0, 0, 1, 1]
    # every rank gathered the same bits, and reported the same metrics
    for r in range(1, 4):
        for key, v in runs["ranks"][0].items():
            if key.startswith(case + "/"):
                assert np.array_equal(runs["ranks"][r][key], v), (r, key)
        assert metas[r]["metrics"] == metas[0]["metrics"]


def test_sharded_runner_replays_a_fault_on_rank_one_bit_for_bit(runs):
    for r, rec in enumerate(runs["runner"]):
        assert rec["restarts"] == [0, 1], (r, rec["restarts"])
        assert rec["replay_same_bits"], r
        clean = {m["step"]: m for m in rec["clean"]}
        assert sorted(clean) == list(range(RUNNER["steps"]))
        for m in rec["fault"]:
            assert m == clean[m["step"]], (r, m)
        # the fault at step 3 restores the step-2 checkpoint: step 2 runs twice
        assert [m["step"] for m in rec["fault"]] == [0, 1, 2, 2, 3]


def test_sharded_checkpoint_restores_in_a_one_rank_run_and_back(runs):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.param import tree_leaves

    tmp = runs["tmp"]
    for r, rec in enumerate(runs["runner"]):
        assert rec["one_rank_restored"] and rec["restored_step"] == RUNNER["every"], (r, rec)
    runner, state = _runner_parts(lambda cfg: None, str(tmp / "ckpt_fault"), None)
    got = runner._restore_latest(state)
    assert got is not None and got[1] == RUNNER["steps"]
    p, o = got[0]
    # the ranks' final state, gathered by rank 0 into the checkpoint, is a
    # one-rank state: one more step from it runs
    from repro_torch.launch.train import build, make_stepper

    cfg, data = build(RUNNER["arch"], seq_len=RUNNER["seq"], global_batch=RUNNER["batch"])
    p2, o2, m = make_stepper(cfg, torch.device("cpu"), total_steps=8)(p, o, data.batch_at(4))
    assert math.isfinite(float(m["loss"])) and int(o2.count) == RUNNER["steps"] + 1
    want = CheckpointManager(str(tmp / "ckpt_clean")).restore_latest(state)[0]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(got[0]),
                                                           tree_leaves(want)))
