"""The port's checkpoint manager against the JAX package's: one wire format
in both directions (npz leaves + a JSON manifest written last), f32 and
bfloat16 leaves bit for bit, dict-keyed trees in ``jax.tree.flatten``'s leaf
order, the same manifest, and torn writes that never load."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.apps.cfd as J  # noqa: E402
import repro_torch.apps.cfd as T  # noqa: E402
from _torch_port import assert_bitwise, to_t  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import manager as tmanager  # noqa: E402

N = 8


def _arrays(dtype: str, seed: int = 0):
    """Three seeded numpy fields; bfloat16 ones as their uint16 bits."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((N, N)).astype(np.float32) for _ in range(3)]
    if dtype == "bfloat16":     # round through the port's bf16 to get its bits
        out = [torch.from_numpy(a).bfloat16().view(torch.int16).numpy().view(np.uint16)
               for a in out]
    return out


def _as_jax(a, dtype):
    if dtype == "bfloat16":
        return jnp.asarray(a.view(jnp.bfloat16))
    return jnp.asarray(a)


def _as_torch(a, dtype):
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return to_t(a)


def _cfd_state(pkg_arrays):
    """The runner's CFD checkpoint tree: ((u, v, p), ())."""
    return (tuple(pkg_arrays), ())


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _same_bits(a, b) -> None:
    ba, bb = _bits(a), _bits(b)
    assert ba.dtype == bb.dtype and ba.shape == bb.shape
    np.testing.assert_array_equal(ba, bb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_written_state_restores_in_the_port(tmp_path, dtype):
    arrs = _arrays(dtype)
    JaxManager(str(tmp_path), keep=3).save(4, _cfd_state([_as_jax(a, dtype) for a in arrs]))
    like = _cfd_state([torch.zeros(N, N, dtype=getattr(torch, dtype)) for _ in arrs])
    (state, extra), step = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 4 and extra == () and isinstance(state, tuple)
    for got, a in zip(state, arrs):
        assert got.dtype == getattr(torch, dtype)
        _same_bits(got, _as_torch(a, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_written_state_restores_in_jax(tmp_path, dtype):
    arrs = _arrays(dtype, seed=1)
    CheckpointManager(str(tmp_path)).save(6, _cfd_state([_as_torch(a, dtype) for a in arrs]))
    like = _cfd_state([jnp.zeros((N, N), jnp.dtype(dtype)) for _ in arrs])
    (state, extra), step = JaxManager(str(tmp_path)).restore_latest(like)
    assert step == 6 and extra == ()
    for got, a in zip(state, arrs):
        _same_bits(got, _as_jax(a, dtype))


def test_both_managers_write_the_same_manifest(tmp_path):
    """The same mixed f32/bf16 state gives the same manifest, digest
    included, and the same leaf arrays."""
    f32, bf = _arrays("float32", seed=2), _arrays("bfloat16", seed=3)
    jtree = {"velocity": (_as_jax(f32[0], "float32"), _as_jax(f32[1], "float32")),
             "pressure": _as_jax(bf[2], "bfloat16"), "extra": [_as_jax(bf[0], "bfloat16")]}
    ttree = {"velocity": (_as_torch(f32[0], "float32"), _as_torch(f32[1], "float32")),
             "pressure": _as_torch(bf[2], "bfloat16"), "extra": [_as_torch(bf[0], "bfloat16")]}
    JaxManager(str(tmp_path / "jax")).save(2, jtree)
    CheckpointManager(str(tmp_path / "port")).save(2, ttree)
    mj = json.loads((tmp_path / "jax" / "step_000000002.json").read_text())
    mt = json.loads((tmp_path / "port" / "step_000000002.json").read_text())
    assert mt == mj
    assert mt["dtypes"] == ["bfloat16", "bfloat16", "float32", "float32"]
    with np.load(tmp_path / "jax" / "step_000000002.npz") as dj, \
            np.load(tmp_path / "port" / "step_000000002.npz") as dt:
        assert sorted(dj.files) == sorted(dt.files)
        for k in dj.files:
            assert dj[k].dtype == dt[k].dtype
            np.testing.assert_array_equal(dj[k], dt[k])


def test_dict_trees_restore_in_the_references_leaf_order(tmp_path):
    """Keys inserted out of order: both packages store leaves by sorted key,
    so each side restores the other's dict leaf for leaf."""
    arrs = _arrays("float32", seed=4)
    keys = ("v", "u", "p")
    CheckpointManager(str(tmp_path / "p")).save(
        1, {k: _as_torch(a, "float32") for k, a in zip(keys, arrs)})
    got, _ = JaxManager(str(tmp_path / "p")).restore(
        1, {k: jnp.zeros((N, N)) for k in keys})
    for k, a in zip(keys, arrs):
        _same_bits(got[k], a)
    JaxManager(str(tmp_path / "j")).save(1, {k: jnp.asarray(a) for k, a in zip(keys, arrs)})
    got, _ = CheckpointManager(str(tmp_path / "j")).restore(
        1, {k: torch.zeros(N, N) for k in keys})
    assert list(got) == sorted(keys)        # rebuilt by sorted key, as jax.tree's
    for k, a in zip(keys, arrs):
        _same_bits(got[k], a)


def test_flatten_matches_jax_tree_flatten():
    import jax

    tree = {"b": (1, [2, 3]), "a": {"y": 4, "x": None}, "c": ()}
    leaves, treedef = tmanager.flatten(tree)
    jleaves, jdef = jax.tree.flatten(tree)
    assert leaves == jleaves
    assert tmanager.treedef_str(treedef) == str(jdef)
    assert tmanager.unflatten(treedef, leaves) == tree


def test_torn_write_never_loads(tmp_path, monkeypatch):
    """The manifest is written last: a save that dies after its npz is in
    place leaves the previous checkpoint the latest, for both packages."""
    arrs = [_as_torch(a, "float32") for a in _arrays("float32", seed=5)]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _cfd_state(arrs))

    def dies(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(tmanager.json, "dump", dies)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(4, _cfd_state([a + 1 for a in arrs]))
    monkeypatch.undo()
    assert os.path.exists(tmp_path / "step_000000004.npz")
    assert mgr.latest_step() == 2 and JaxManager(str(tmp_path)).latest_step() == 2
    like = _cfd_state([torch.zeros(N, N) for _ in arrs])
    (state, _), step = mgr.restore_latest(like)
    assert step == 2
    for got, a in zip(state, arrs):
        assert torch.equal(got, a)


def test_keep_async_and_structure_checks(tmp_path):
    arrs = [_as_torch(a, "float32") for a in _arrays("float32", seed=6)]
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, _cfd_state([a * step for a in arrs]), blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    like64 = _cfd_state([torch.zeros(N, N, dtype=torch.float64) for _ in arrs])
    (state, _), step = mgr.restore_latest(like64)
    assert step == 3 and state[0].dtype == torch.float64
    assert torch.equal(state[0], (arrs[0] * 3).double())
    with pytest.raises(ValueError, match="tree structure changed"):
        mgr.restore(3, (tuple(arrs[:2]), ()))


def test_jax_transient_checkpoint_resumes_in_the_port(tmp_path):
    """A transient CFD march checkpointed by the JAX package resumes in the
    port from the same state, bit for bit, at the next step."""
    kw = dict(n=N, reynolds=100.0)
    tk = dict(dt=0.05, n_steps=2, outers_per_step=2, checkpoint_every=2)
    (ju, jv, jp), _ = J.run_transient(J.CFDConfig(**kw), J.TransientConfig(**tk),
                                      checkpoint_dir=str(tmp_path))
    like = _cfd_state([torch.zeros(N, N) for _ in range(3)])
    (state, _), step = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 2
    for got, ref in zip(state, (ju, jv, jp)):
        assert_bitwise(got, ref)
    tk["n_steps"] = 3
    _, metrics = T.run_transient(T.CFDConfig(**kw), T.TransientConfig(**tk),
                                 checkpoint_dir=str(tmp_path), device="cpu")
    assert [m["step"] for m in metrics] == [2]
