"""The train step across the ranks of a ``RankMesh``: what GSPMD makes of
the reference's ``jit(make_train_step)`` over a mesh, as storage, not as a
copy of its partitioning.

* *Storage.*  Each rank keeps, of every parameter leaf, the block that
  ``physical_spec`` gives it under the config's ``rules``; of every AdamW
  moment the ``zero1_spec`` block (the parameter's spec plus the batch
  axes over its largest free dimension); ``count`` on every rank.
* *Batch.*  The global batch is split over its batch axes (``pod``,
  ``data``) as ``input_specs`` places it; ranks that differ only in
  ``model`` take the same shard.
* *Step.*  (a) Gather each leaf (one all-gather per split dimension).  (b)
  The forward and backward of ``model.loss_fn`` on the shard, under a
  ``param.BatchSplit``: the loss's normaliser, the MoE's token groups and
  its load-balancing loss are the global batch's, so the shards' losses and
  gradients add up to the one-rank step's of the global batch.  (c) Each
  gradient summed over the batch axes into its ZeRO-1 block: a
  reduce-scatter of this rank's parameter block when the ZeRO-1 axes are
  the batch axes, else an all-reduce and a slice.  (d) The global norm of
  the full gradients from the blocks (each block counted once: the ranks
  at coordinate 0 of the axes it is replicated over), one all-reduce of
  the per-leaf sums.  (e) AdamW on this rank's blocks of the moments and
  parameters.  (f) Each parameter block put back together from the updated
  ZeRO-1 blocks (an all-gather over the ZeRO-1 axes).

The arithmetic is not split over ``model``: the ranks along it compute the
same shard with the same gathered leaves (and, the kernels being
deterministic, get the same bits), where the reference's compiled step
splits its products Megatron-style.  Leaves replicated over an axis are
updated by every rank holding them, as GSPMD's replicated computations
are.  On a 1 x 1 mesh the step is ``model.make_train_step``'s, bit for bit.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.dist import MeshComm
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.models.param import (
    BatchSplit, block_slices, gather_leaf, map_tree, physical_spec, rule_overrides,
    shard_leaf, split_batch, tree_leaves, zero1_spec,
)
from repro_torch.optim.adamw import AdamWState, adamw_update, cosine_lr

F32 = torch.float32


class ShardedLayout:
    """Where every leaf of ``cfg``'s training state and every row of a
    global batch of ``global_batch`` sequences lives on ``mesh``, seen from
    ``mesh.rank``; ``comm`` carries the collectives (a recording
    ``MeshComm`` in the dry-run)."""

    def __init__(self, cfg, mesh, global_batch: int, comm: MeshComm | None = None):
        self.cfg, self.mesh = cfg, mesh
        self.comm = comm if comm is not None else MeshComm(mesh)
        self.defs = transformer.build_model_defs(cfg)
        with rule_overrides(dict(cfg.rules)):
            self.pspec = {k: physical_spec(d.shape, d.axes, mesh)
                          for k, d in tree_leaves(self.defs)}
            self.zspec = {k: zero1_spec(d.shape, d.axes, mesh) for k, d in tree_leaves(self.defs)}
            self.batch_axes = physical_spec((global_batch,), ("batch",), mesh).dim_axes(0)
        sizes, coords = mesh.shape, mesh.coords
        self.shards = math.prod(sizes[a] for a in self.batch_axes)
        self.shard_index = 0
        for a in self.batch_axes:
            self.shard_index = self.shard_index * sizes[a] + coords[a]
        self.global_batch = global_batch

    # -- the batch ---------------------------------------------------------------

    def batch_shard(self, batch: dict) -> dict:
        """This rank's rows of a global batch (numpy arrays or tensors)."""
        n = self.global_batch // self.shards
        lo = self.shard_index * n
        return {k: v[lo:lo + n] for k, v in batch.items()}

    def split(self) -> BatchSplit | None:
        if self.shards == 1:
            return None
        ax = self.batch_axes
        return BatchSplit(self.shards, self.shard_index,
                          sum=lambda t: self.comm.all_reduce_sum(t, ax),
                          gather=lambda t: self.comm.all_gather(t[None], ax, dim=0))

    # -- the state ---------------------------------------------------------------

    def _added(self, path: str) -> tuple[int, tuple[str, ...]]:
        """(dimension, axes) that ZeRO-1 adds to the parameter's spec, or (-1, ())."""
        p, z = self.pspec[path], self.zspec[path]
        for d in range(len(z)):
            if z.dim_axes(d) and not p.dim_axes(d):
                return d, z.dim_axes(d)
        return -1, ()

    def shard(self, params: dict) -> dict:
        """This rank's parameter blocks of a full parameter tree."""
        return map_tree(lambda k, t: shard_leaf(t, self.pspec[k], self.mesh), params,
                        with_path=True)

    def shard_opt(self, opt: AdamWState) -> AdamWState:
        """This rank's ZeRO-1 blocks of full moments (``count`` kept)."""
        cut = lambda tree: map_tree(lambda k, t: shard_leaf(t, self.zspec[k], self.mesh),
                                    tree, with_path=True)
        return AdamWState(cut(opt.mu), cut(opt.nu), opt.count)

    def gather(self, params: dict) -> dict:
        """The full parameter tree from every rank's blocks (collective)."""
        return map_tree(lambda k, t: gather_leaf(t, self.pspec[k], self.mesh, self.comm),
                        params, with_path=True)

    def gather_opt(self, opt: AdamWState) -> AdamWState:
        """The full moments from every rank's ZeRO-1 blocks (collective)."""
        put = lambda tree: map_tree(
            lambda k, t: gather_leaf(t, self.zspec[k], self.mesh, self.comm), tree,
            with_path=True)
        return AdamWState(put(opt.mu), put(opt.nu), opt.count)

    def full_state(self, state):
        """(params, opt) as full trees on every rank, in the reference's
        layout (a checkpoint's)."""
        params, opt = state
        return self.gather(params), self.gather_opt(opt)

    def local_state(self, state):
        """This rank's blocks of a full (params, opt)."""
        params, opt = state
        return self.shard(params), self.shard_opt(opt)

    def full_like(self, state):
        """Empty full-shape tensors of the state's dtypes on its device: the
        structure a restore reads a checkpoint into."""
        params, opt = state
        dev = tree_leaves(params)[0][1].device
        like = lambda dtype: map_tree(
            lambda d: torch.empty(d.shape, dtype=dtype or d.dtype, device=dev), self.defs)
        return like(None), AdamWState(like(F32), like(F32), opt.count)

    @staticmethod
    def stored_bytes(tree) -> int:
        return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))


def make_sharded_train_step(cfg, layout: ShardedLayout, *, lr_peak: float = 3e-4,
                            total_steps: int = 10000):
    """``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on this rank's blocks (:class:`ShardedLayout`) and this rank's batch
    shard (``layout.batch_shard``), with ``model.make_train_step``'s
    metrics: the global batch's loss, auxiliary and total loss, the learning
    rate and the step count.  Functional, as the one-rank step is."""
    comm, mesh = layout.comm, layout.mesh
    bax = layout.batch_axes
    every = tuple(mesh.axis_names)
    coords = mesh.coords

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        leaves = tree_leaves(params)
        M._matmul_flags(leaves[0][1].device)
        full = {k: gather_leaf(t, layout.pspec[k], mesh, comm) for k, t in leaves}   # (a)
        live = {k: t.detach().requires_grad_() for k, t in full.items()}
        p = map_tree(lambda k, _: live[k], params, with_path=True)
        with torch.enable_grad(), split_batch(layout.split()):                     # (b)
            total, (loss, aux) = M.loss_fn(cfg, p, batch)
            grads = torch.autograd.grad(total, list(live.values()), allow_unused=True)
        del p, live
        gz, pz, sq = {}, {}, []
        for (k, _), g in zip(leaves, grads):                                        # (c)
            g = torch.zeros_like(full[k]) if g is None else g
            pspec, zspec = layout.pspec[k], layout.zspec[k]
            dim, added = layout._added(k)
            if bax and set(added) == set(bax) and not set(pspec.mesh_axes()) & set(bax):
                mine = g[block_slices(tuple(g.shape), pspec, mesh)]
                gz[k] = comm.reduce_scatter(mine, added, dim)
            else:
                gz[k] = comm.all_reduce_sum(g, bax)[block_slices(tuple(g.shape), zspec, mesh)]
            pz[k] = full[k][block_slices(tuple(g.shape), zspec, mesh)]
            counted = all(coords[a] == 0 for a in every if a not in zspec.mesh_axes())
            sq.append(torch.sum(torch.square(gz[k].to(F32))) if counted
                      else torch.zeros((), dtype=F32, device=g.device))
        del full, grads
        sums = comm.all_reduce_sum(torch.stack(sq), every)                          # (d)
        gn = torch.sqrt(sum(sums[i] for i in range(len(sq))))
        tree = lambda d: map_tree(lambda k, _: d[k], params, with_path=True)
        lr = cosine_lr(opt_state.count, peak=lr_peak, total=total_steps)
        pz, opt_state = adamw_update(tree(pz), tree(gz), opt_state, lr=lr, grad_norm=gn)  # (e)

        def reform(k, t):                                                           # (f)
            dim, added = layout._added(k)
            return comm.all_gather(t, added, dim) if added else t

        new = map_tree(reform, pz, with_path=True)
        parts = comm.all_reduce_sum(torch.stack([loss.detach(), torch.as_tensor(
            aux, dtype=F32, device=loss.device).detach(), total.detach()]), bax)
        metrics = {"loss": parts[0], "aux_loss": parts[1], "total_loss": parts[2],
                   "lr": lr, "grad_step": opt_state.count}
        return new, opt_state, metrics

    return train_step
