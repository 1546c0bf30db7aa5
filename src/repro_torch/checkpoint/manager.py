"""Checkpointing: atomic, async, in the JAX package's wire format.

Counterpart of ``repro/checkpoint/manager.py``, file for file: one
``step_XXXXXXXXX.npz`` per checkpoint step holding every leaf of the state
tree as a full array (``leaf_0``, ``leaf_1``, ...), plus a JSON manifest
with the tree structure, the step, and an integrity digest.  Writes go to a
temp name and are renamed into place (atomic on POSIX), and the manifest is
written last, so a crash mid-write can never yield a checkpoint that loads —
the runner simply falls back to the previous manifest.

The format is the reference's, so a state carries across: a checkpoint the
JAX package wrote restores here, and one written here restores there.

* Leaf order: the reference flattens with ``jax.tree.flatten``, which sorts
  dict keys; :func:`flatten` walks tuples, lists and dicts the same way (a
  ``None`` holds no leaf), and a dataclass record (the optimizer's
  ``AdamWState``) by its fields in declaration order, as JAX walks a
  registered dataclass; every leaf is a tensor.  The manifest's
  ``treedef`` string is informative; restore checks ``n_leaves``.
* bfloat16: npz holds no bfloat16, so such leaves are stored as ``uint16``
  bit views with the logical dtype ``"bfloat16"`` in the manifest, and
  rebuilt through an ``int16 -> bfloat16`` view: the bits are the bits.
* ``digest``: sha256 over the first 4096 logical bytes of each leaf, the
  reference's, so both packages write the same digest for the same state.

Async: ``save(..., blocking=False)`` snapshots to host memory synchronously
and writes in a background thread, keeping serialization off the critical
path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

#: logical dtype -> the same-width unsigned view npz stores it as
_VIEW_AS = {"bfloat16": np.uint16}


def flatten(tree) -> tuple[list, object]:
    """(leaves, treedef) in ``jax.tree.flatten``'s order: tuples and lists
    in order, dicts by sorted key, a dataclass record by its fields,
    ``None`` empty, anything else a leaf."""
    if tree is None:
        return [], None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        leaves, defs = [], []
        for n in names:
            sub_leaves, sub_def = flatten(getattr(tree, n))
            leaves += sub_leaves
            defs.append(sub_def)
        return leaves, ("record", type(tree), names, defs)
    if isinstance(tree, (tuple, list)):
        leaves, defs = [], []
        for sub in tree:
            sub_leaves, sub_def = flatten(sub)
            leaves += sub_leaves
            defs.append(sub_def)
        return leaves, (type(tree), defs)
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            sub_leaves, sub_def = flatten(tree[k])
            leaves += sub_leaves
            defs.append(sub_def)
        return leaves, (dict, keys, defs)
    return [tree], "*"


def unflatten(treedef, leaves: list):
    """Inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "*":
            return next(it)
        if d[0] == "record":
            return d[1](**{n: build(sub) for n, sub in zip(d[2], d[3])})
        if d[0] is dict:
            return {k: build(sub) for k, sub in zip(d[1], d[2])}
        return d[0](build(sub) for sub in d[1])

    return build(treedef)


def treedef_str(treedef) -> str:
    """The structure in the reference manifest's notation, e.g.
    ``PyTreeDef(((*, *, *), ()))``."""
    def show(d):
        if d is None:
            return "None"
        if d == "*":
            return "*"
        if d[0] == "record":
            return f"CustomNode({d[1].__name__}[()], [{', '.join(show(x) for x in d[3])}])"
        if d[0] is dict:
            return "{" + ", ".join(f"'{k}': {show(s)}" for k, s in zip(d[1], d[2])) + "}"
        inner = ", ".join(show(s) for s in d[1])
        if d[0] is list:
            return f"[{inner}]"
        return f"({inner},)" if len(d[1]) == 1 else f"({inner})"

    return f"PyTreeDef({show(treedef)})"


def _host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array npz stores, the logical dtype name) of one tensor leaf;
    the stored array's bytes are the leaf's logical bytes."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_VIEW_AS["bfloat16"]), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _restore_leaf(arr: np.ndarray, logical: str, like: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor on ``like``'s device and in its dtype (a
    0-d array stays 0-d: ``ascontiguousarray`` alone returns it 1-d)."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if logical == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: threading.Thread | None = None

    # -- paths ---------------------------------------------------------------

    def _npz(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}.npz")

    def _manifest(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}.json")

    def all_steps(self) -> list[int]:
        steps = []
        for f in os.listdir(self.dir):
            if f.endswith(".json") and f.startswith("step_"):
                steps.append(int(f[5:-5]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree, *, blocking: bool = True) -> None:
        leaves, treedef = flatten(tree)
        # snapshot to host synchronously; the caller may overwrite its tensors next
        host = [_host(leaf) for leaf in leaves]
        if self._pending is not None:
            self._pending.join()

        def write():
            # runs on the writer thread for async saves; spans/counters are
            # thread-safe (the registry locks, span stacks are thread-local)
            with self._lock, obs_trace.span("checkpoint.write", step=step,
                                            blocking=blocking):
                tmp = self._npz(step) + ".tmp.npz"  # savez appends .npz itself
                np.savez(tmp, **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
                os.replace(tmp, self._npz(step))
                digest = hashlib.sha256()
                for a, _ in host:
                    digest.update(np.ascontiguousarray(a).tobytes()[:4096])
                man = {
                    "step": step,
                    "n_leaves": len(host),
                    "treedef": treedef_str(treedef),
                    "digest": digest.hexdigest(),
                    "shapes": [list(a.shape) for a, _ in host],
                    "dtypes": [logical for _, logical in host],
                }
                mtmp = self._manifest(step) + ".tmp"
                with open(mtmp, "w") as f:
                    json.dump(man, f)
                os.replace(mtmp, self._manifest(step))
                self._gc()

        obs_metrics.counter("checkpoint.saves").inc()
        obs_metrics.counter(
            "checkpoint.saves_async" if not blocking else
            "checkpoint.saves_blocking").inc()
        if blocking:
            write()
        else:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            for p in (self._npz(s), self._manifest(s)):
                if os.path.exists(p):
                    os.remove(p)

    # -- restore ---------------------------------------------------------------

    def restore(self, step: int, like):
        """Restore into the structure of ``like``, a tree of tensors: each
        leaf comes back on the device and in the dtype of ``like``'s."""
        obs_metrics.counter("checkpoint.restores").inc()
        with open(self._manifest(step)) as f:
            man = json.load(f)
        with obs_trace.span("checkpoint.restore", step=step):
            with np.load(self._npz(step)) as data:
                stored = [data[f"leaf_{i}"] for i in range(man["n_leaves"])]
        leaves_like, treedef = flatten(like)
        if man["n_leaves"] != len(leaves_like):
            raise ValueError(f"tree structure changed: the checkpoint holds "
                             f"{man['n_leaves']} leaves, the state {len(leaves_like)}")
        out = [_restore_leaf(arr, man["dtypes"][i], leaf)
               for i, (arr, leaf) in enumerate(zip(stored, leaves_like))]
        return unflatten(treedef, out), man["step"]

    def restore_latest(self, like):
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, like)
