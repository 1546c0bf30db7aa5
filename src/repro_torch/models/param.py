"""Parameter declaration + logical-axis sharding (MaxText-style rules).

The port of ``repro/models/param.py``.  Each parameter is declared once
with its shape, logical axes, initialiser and dtype; trees of ``ParamDef``
are nested dicts (and ``AttnCache`` records) exactly as the JAX package
builds them, so the structure of a full-width model can be compared leaf by
leaf with no allocation.

The mesh half maps logical axes onto the axes of a
:class:`repro_torch.launch.mesh.RankMesh` with the reference's rules
(``DEFAULT_RULES``, cell-scoped ``rule_overrides``, a mapping that does not
divide is dropped): ``physical_spec`` and ``zero1_spec`` give a
:class:`Spec`, the port's counterpart of ``PartitionSpec``, and
``shard_leaf``/``gather_leaf`` cut a rank's block out of a full tensor and
put the full tensor back together from the blocks.  The port's sharded step
(``runtime/sharded.py``) splits storage by these specs, not arithmetic, so
``constrain`` stays the identity.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device, tensor_from_numpy


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]            # logical axis names, len == len(shape)
    init: str = "normal"                    # normal | zeros | ones | embed
    scale: float | None = None              # override fan-in scaling
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


# Logical axis -> preferred mesh axis (or tuple). None = always replicated.
DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "heads_flat": "model",    # flattened (H*Dh) projections (RWKV, Mamba d_inner)
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "expert_ff": "model",
    "moe_groups": ("pod", "data"),   # MoE token groups follow the batch axes
    "d_model": None,
    "seq": None,
    "seq_act": "model",       # layer-boundary activations (a constraint only)
    "kv_seq": "model",        # decode shapes: KV-cache sequence sharding
    "conv": None,
    "state": None,
    "layers": None,           # stacked-period leading axis
}


# Cell-scoped sharding-rule overrides (a config's ``rules``), set with
# ``with rule_overrides({...}):`` around spec construction.
_RULE_OVERRIDES: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "repro_torch_rule_overrides", default={})


@contextlib.contextmanager
def rule_overrides(rules: dict):
    tok = _RULE_OVERRIDES.set({**_RULE_OVERRIDES.get(), **rules})
    try:
        yield
    finally:
        _RULE_OVERRIDES.reset(tok)


@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """The global batch of a sharded train step, cut into ``count`` shards
    (this rank holds shard ``index``), with the collectives over the ranks
    that hold the other shards: ``sum(t)`` adds every shard's ``t``,
    ``gather(t)`` stacks them on a new leading axis in shard order.  Read by
    the code that needs a global quantity of the batch (``model.loss_fn``'s
    normaliser, ``moe``'s token groups and load-balancing loss)."""

    count: int
    index: int
    sum: Callable[[torch.Tensor], torch.Tensor]
    gather: Callable[[torch.Tensor], torch.Tensor]


_BATCH_SPLIT: contextvars.ContextVar[BatchSplit | None] = contextvars.ContextVar(
    "repro_torch_batch_split", default=None)


def batch_split() -> BatchSplit | None:
    """The ambient :class:`BatchSplit`, or None: the batch is the global one."""
    return _BATCH_SPLIT.get()


@contextlib.contextmanager
def split_batch(split: BatchSplit | None):
    tok = _BATCH_SPLIT.set(split)
    try:
        yield
    finally:
        _BATCH_SPLIT.reset(tok)


class Spec(tuple):
    """Where each dimension of a leaf lives on a rank mesh: ``None``
    (whole on every rank), an axis name, or a tuple of axis names (split
    over their product, the first axis major); trailing ``None`` entries
    dropped, as ``PartitionSpec`` keeps them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"Spec({', '.join(map(repr, self))})"

    def dim_axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes dimension ``dim`` is split over (major first)."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e,) if isinstance(e, str) else tuple(e)

    def mesh_axes(self) -> tuple[str, ...]:
        return tuple(a for d in range(len(self)) for a in self.dim_axes(d))


def constrain(x: torch.Tensor, axes: tuple[str | None, ...], rules: dict | None = None):
    """The identity: the port splits storage, not the arithmetic."""
    return x


def _mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(mesh.shape)


def physical_spec(shape: tuple[int, ...], axes: tuple[str | None, ...], mesh,
                  rules: dict | None = None) -> Spec:
    """Logical axes -> Spec, dropping non-dividing mappings."""
    rules = {**DEFAULT_RULES, **_RULE_OVERRIDES.get(), **(rules or {})}
    sizes = _mesh_axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for dim, ax in zip(shape, axes):
        phys = rules.get(ax) if ax is not None else None
        if phys is None:
            out.append(None)
            continue
        cand = (phys,) if isinstance(phys, str) else tuple(phys)
        cand = tuple(a for a in cand if a in sizes and a not in used)
        total = math.prod(sizes[a] for a in cand) if cand else 1
        if cand and dim % total == 0:
            out.append(cand if len(cand) > 1 else cand[0])
            used.update(cand)
        else:
            # shrink a multi-axis mapping from the left (e.g. batch on
            # ("pod","data") where only "data" divides)
            placed = None
            for i in range(1, len(cand)):
                sub = cand[i:]
                if dim % math.prod(sizes[a] for a in sub) == 0:
                    placed = sub if len(sub) > 1 else sub[0]
                    used.update(sub)
                    break
            out.append(placed)
    while out and out[-1] is None:
        out.pop()
    return Spec(*out)


def sharding_tree(defs, mesh, rules: dict | None = None):
    """ParamDef tree -> Spec tree."""
    return map_tree(lambda d: physical_spec(d.shape, d.axes, mesh, rules), defs)


def zero1_spec(shape: tuple[int, ...], axes: tuple[str | None, ...], mesh,
               rules: dict | None = None) -> Spec:
    """ZeRO-1: the parameter's spec plus the batch axes spread over the
    largest still-unsplit dimension they divide.  Used for the optimizer
    moments: f32 Adam state is 4x the bf16 parameters."""
    base = physical_spec(shape, axes, mesh, rules)
    entries = list(base) + [None] * (len(shape) - len(base))
    sizes = _mesh_axis_sizes(mesh)
    used = set(base.mesh_axes())
    free = [a for a in ("data", "pod") if a in sizes and a not in used]
    if free:
        extra = math.prod(sizes[a] for a in free)
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if entries[i] is None and shape[i] % extra == 0:
                entries[i] = tuple(free) if len(free) > 1 else free[0]
                break
    while entries and entries[-1] is None:
        entries.pop()
    return Spec(*entries)


def zero1_sharding_tree(defs, mesh, rules: dict | None = None):
    return map_tree(lambda d: zero1_spec(d.shape, d.axes, mesh, rules), defs)


def abstract_tree(defs, mesh=None, rules: dict | None = None):
    """ParamDef tree -> meta tensors of each leaf's full shape and dtype,
    each carrying its :class:`Spec` as ``.spec`` when a mesh is given."""
    def mk(d: ParamDef):
        t = torch.empty(d.shape, dtype=d.dtype, device="meta")
        if mesh is not None:
            t.spec = physical_spec(d.shape, d.axes, mesh, rules)
        return t
    return map_tree(mk, defs)


def block_slices(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[slice, ...]:
    """The index of this rank's (``mesh.rank``) block of a tensor of
    ``shape`` placed by ``spec``."""
    coords, sizes = mesh.coords, _mesh_axis_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        ax = spec.dim_axes(d)
        parts, at = 1, 0
        for a in ax:                    # row-major over the dimension's axes
            parts, at = parts * sizes[a], at * sizes[a] + coords[a]
        assert n % parts == 0, (shape, spec)
        step = n // parts
        out.append(slice(at * step, (at + 1) * step))
    return tuple(out)


def shard_leaf(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` (a contiguous copy)."""
    return t[block_slices(tuple(t.shape), spec, mesh)].contiguous()


def gather_leaf(block: torch.Tensor, spec: Spec, mesh, comm=None) -> torch.Tensor:
    """The full tensor from every rank's ``block``: one all-gather over the
    axes of each split dimension (``comm``: a ``core.dist.MeshComm`` of
    ``mesh``; none is needed when nothing is split)."""
    for d in range(len(spec)):
        ax = spec.dim_axes(d)
        if ax and math.prod(_mesh_axis_sizes(mesh)[a] for a in ax) > 1:
            block = comm.all_gather(block, ax, dim=d)
    return block


def map_tree(fn: Callable[..., Any], tree, *, with_path: bool = False, _prefix: str = ""):
    """Apply ``fn`` to every leaf of a nested dict / list / dataclass tree
    (``fn(path, leaf)`` with ``with_path``, paths joined with ``/``).

    A leaf is anything but a dict, list, tuple or dataclass instance; a
    ``ParamDef`` and a :class:`Spec` are leaves.
    """
    def sub(v, k):
        return map_tree(fn, v, with_path=with_path, _prefix=f"{_prefix}{k}/")

    if isinstance(tree, dict):
        return {k: sub(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(sub(v, i) for i, v in enumerate(tree))
    if _is_record(tree):
        return dataclasses.replace(tree, **{f.name: sub(getattr(tree, f.name), f.name)
                                            for f in dataclasses.fields(tree)})
    return fn(_prefix.rstrip("/"), tree) if with_path else fn(tree)


def map_trees(fn: Callable[..., Any], tree, *others):
    """``fn(leaf, *other_leaves)`` over trees of one structure (the first
    tree's: dicts, lists, tuples and dataclass records), returning a tree of
    that structure."""
    if isinstance(tree, dict):
        return {k: map_trees(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(map_trees(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    if _is_record(tree):
        return dataclasses.replace(tree, **{
            f.name: map_trees(fn, getattr(tree, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(tree)})
    return fn(tree, *others)


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs, dict keys sorted (``jax.tree.flatten``'s order)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return [kv for i, v in enumerate(tree) for kv in tree_leaves(v, f"{prefix}{i}/")]
    if _is_record(tree):
        return [kv for f in dataclasses.fields(tree)
                for kv in tree_leaves(getattr(tree, f.name), f"{prefix}{f.name}/")]
    return [(prefix.rstrip("/"), tree)]


def _is_record(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, (type, ParamDef))


def _init_leaf(d: ParamDef, gen: torch.Generator) -> torch.Tensor:
    """One parameter, drawn on the generator's device in float32 and cast,
    with the JAX package's initialisers and scales."""
    dev = gen.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    if d.init == "embed":
        # unit-variance rows scaled by 1/sqrt(d) so tied logits start O(1)
        s = 1.0 / math.sqrt(d.shape[-1])
    else:
        fan_in = d.shape[0] if len(d.shape) == 1 else math.prod(d.shape[:-1])
        s = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=gen, device=dev, dtype=torch.float32)
    return x.mul_(s).to(d.dtype)


def init_tree(defs, gen: torch.Generator, device: str | torch.device | None = None):
    """ParamDef tree -> tensors, drawn leaf by leaf in ``jax.tree.flatten``
    order on ``gen`` (on its device) and placed on ``device`` (default: the
    generator's).  The values are not the JAX package's: a test that needs
    the same weights carries the JAX tree across (``params_from_numpy``)."""
    dev = gen.device if device is None else torch.device(device)
    made = {path: _init_leaf(d, gen).to(dev) for path, d in tree_leaves(defs)}
    return map_tree(lambda path, _: made[path], defs, with_path=True)


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for _, d in tree_leaves(defs))


def stack_defs(defs, n: int):
    """Prepend a ``layers`` axis of length n to every ParamDef in the tree."""
    return map_tree(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes, d.init, d.scale, d.dtype),
        defs)


def params_from_numpy(cfg, tree, device: str | torch.device | None = "cuda"):
    """The JAX package's parameter tree (``repro.models.model.init_params``),
    handed over as numpy arrays (bfloat16 bits kept), as this package's model
    (:class:`repro_torch.models.transformer.DecoderLM`) on ``device``."""
    from repro_torch.models.transformer import DecoderLM

    dev = resolve_device(device)
    return DecoderLM.from_tree(cfg, tree_from_numpy(tree, dev))


def tree_from_numpy(tree, device: str | torch.device | None = "cuda"):
    """A tree of numpy arrays (the JAX package's stacked parameter tree, its
    gradients or an ``AdamWState``, bfloat16 bits kept) as the same tree of
    tensors on ``device``: the training layout, leaf for leaf."""
    dev = resolve_device(device)
    return map_tree(lambda a: tensor_from_numpy(np.asarray(a), dev), tree)


def tree_to_numpy(tree):
    """The reverse of :func:`tree_from_numpy`: every tensor leaf as a numpy
    array on the host in its own dtype, except bfloat16, which numpy lacks
    and which widens to float32 exactly."""
    from repro_torch.device import tensor_to_numpy

    return map_tree(tensor_to_numpy, tree)
