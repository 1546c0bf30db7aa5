"""Parameter declaration: ``ParamDef`` trees, their initialisation and counts.

The port of ``repro/models/param.py`` for one device.  Each parameter is
declared once with its shape, logical axes, initialiser and dtype; trees of
``ParamDef`` are nested dicts (and ``AttnCache`` records) exactly as the JAX
package builds them, so the structure of a full-width model can be compared
leaf by leaf with no allocation.  The mesh machinery (``physical_spec``,
``sharding_tree``, the ZeRO-1 specs, ``abstract_tree``, ``rule_overrides``)
has no use on one device and is not ported; ``constrain`` is the identity.
"""

from __future__ import annotations

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


def constrain(x: torch.Tensor, axes: tuple[str | None, ...], rules: dict | None = None):
    """The identity: one device has no sharding to constrain."""
    return x


def map_tree(fn: Callable[..., Any], tree, *, with_path: bool = False, _prefix: str = ""):
    """Apply ``fn`` to every leaf of a nested dict / list / dataclass tree
    (``fn(path, leaf)`` with ``with_path``, paths joined with ``/``).

    A leaf is anything but a dict, list, tuple or dataclass instance; a
    ``ParamDef`` is a leaf.
    """
    def sub(v, k):
        return map_tree(fn, v, with_path=with_path, _prefix=f"{_prefix}{k}/")

    if isinstance(tree, dict):
        return {k: sub(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
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
    if isinstance(tree, (list, tuple)):
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
    if isinstance(tree, (list, tuple)):
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
