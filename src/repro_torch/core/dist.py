"""Rank plumbing over ``torch.distributed``: the port's counterpart of the
``jax.lax.ppermute`` / ``psum`` / ``pmax`` / ``axis_index`` calls the JAX
package makes inside ``shard_map``.

Every rank runs the same program on its own block.  This module gives it:

* :func:`init`: join the process group from ``torchrun``'s environment, or
  from an explicit ``init_method`` (the tests use ``file://``), and pick the
  rank's device;
* :func:`all_reduce_sum` / :func:`all_reduce_max`: one AllReduce each,
  counted in ``comm.allreduce``;
* :func:`exchange`: the bidirectional nearest-neighbour exchange of two
  slabs along one fabric axis (the ``fwd`` and ``bwd`` permutes of
  ``repro/core/halo.py:_exchange``), posted as point-to-point messages and
  waited on later, counted as 2 in ``comm.ppermute`` on every rank as the
  JAX package counts its collective permutes.  Edge ranks get zeros, the
  Dirichlet boundary;
* uncounted helpers that move whole blocks (:func:`all_gather`,
  :func:`scatter_from_root`, :func:`barrier`), used where global arrays
  enter or leave a run, never inside the solve loop.

Backends are chosen explicitly.  ``nccl`` puts one rank on each card and
refuses a world larger than the card count.  ``gloo`` lets ranks share a
card: every slab and every AllReduce operand of a card tensor is then
staged through host memory by explicit copies (counted in
``comm.host_staged_bytes``), and slabs travel as raw bytes, so bf16 crosses
exactly.  Nothing here runs on a one-rank fabric: with no process group, or
a world of 1, the callers never reach a ``torch.distributed`` call.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch

from repro_torch.obs import metrics as obs_metrics

BACKENDS = ("nccl", "gloo")
#: how long a collective may wait on a peer before the run fails
TIMEOUT = datetime.timedelta(seconds=600)
#: every rank's device, in rank order, gathered once when the group starts
_RANK_DEVICES: list[str] = []


def _td():
    import torch.distributed as td

    return td


def initialized() -> bool:
    td = _td()
    return td.is_available() and td.is_initialized()


def world_size() -> int:
    return _td().get_world_size() if initialized() else 1


def rank() -> int:
    return _td().get_rank() if initialized() else 0


def is_root() -> bool:
    return rank() == 0


def backend() -> str | None:
    return str(_td().get_backend()) if initialized() else None


def default_backend(device_type: str) -> str:
    """``nccl`` for the card, ``gloo`` for the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def launched() -> bool:
    """Whether this process was started by ``torchrun`` (or set up as one of
    its ranks): ``WORLD_SIZE`` is in the environment."""
    return "WORLD_SIZE" in os.environ


def init(backend_name: str | None = None, *, device_type: str = "cuda",
         init_method: str | None = None, world: int | None = None,
         rank_id: int | None = None) -> torch.device:
    """Join the process group (once) and return this rank's device.

    Without ``init_method`` the group comes from ``torchrun``'s environment
    (``env://``).  On the card, rank r takes ``cuda:{LOCAL_RANK}`` under
    ``nccl`` and ``cuda:{LOCAL_RANK % device_count}`` under ``gloo``.
    """
    backend_name = backend_name or default_backend(device_type)
    if backend_name not in BACKENDS:
        raise ValueError(f"unknown dist backend {backend_name!r}; have {list(BACKENDS)}")
    if backend_name == "nccl" and device_type != "cuda":
        raise ValueError("the nccl backend runs on the card; use --dist-backend gloo on the CPU")
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else world
    rank_id = int(os.environ.get("RANK", 0)) if rank_id is None else rank_id
    local = int(os.environ.get("LOCAL_RANK", rank_id))
    device = torch.device("cpu")
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if backend_name == "nccl" and world > n:
            raise ValueError(
                f"the nccl backend puts one rank on each card, and {world} ranks exceed "
                f"the {n} card(s) here; pass --dist-backend gloo to let ranks share a card")
        device = torch.device("cuda", local % n)
        torch.cuda.set_device(device)
    if not initialized():
        kw = dict(backend=backend_name, timeout=TIMEOUT)
        if init_method is not None:
            kw.update(init_method=init_method, world_size=world, rank=rank_id)
        _td().init_process_group(**kw)
        if backend_name == "nccl" and world > 1:
            _td().barrier()       # every rank joins the communicator before any P2P
        _RANK_DEVICES[:] = all_gather_object(str(device)) if world > 1 else [str(device)]
    return device


def describe() -> dict:
    """What a run bundle's manifest records of the group: world size,
    backend and the rank-to-device map (one rank, no group: world 1)."""
    return {"world_size": world_size(), "backend": backend(),
            "rank_devices": list(_RANK_DEVICES)}


def shutdown() -> None:
    if initialized():
        _td().destroy_process_group()


def check_fabric(size: int) -> None:
    """Raise unless a process group of exactly ``size`` ranks is running."""
    if size > 1 and world_size() != size:
        raise RuntimeError(
            f"a fabric of {size} ranks needs an initialized torch.distributed process "
            f"group of {size} ranks (this process sees a world of {world_size()}); start "
            f"it under torchrun --nproc-per-node {size} or call repro_torch.core.dist.init")


def _staged(t: torch.Tensor) -> bool:
    """A card tensor under gloo travels through host memory."""
    return t.device.type == "cuda" and backend() == "gloo"


def _count_staged(nbytes: int) -> None:
    obs_metrics.counter("comm.host_staged_bytes").inc(nbytes)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` as they travel: contiguous, on the host when
    staged (a synchronous copy, finished before the send is posted)."""
    t = t.contiguous()
    if _staged(t):
        _count_staged(t.numel() * t.element_size())
        t = t.cpu()
    return t.reshape(-1).view(torch.uint8)


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    obs_metrics.counter("comm.allreduce").inc()
    if _staged(x):
        buf = x.detach().cpu()
        _count_staged(2 * buf.numel() * buf.element_size())
        _td().all_reduce(buf, op=op)
        return buf.to(x.device)
    buf = x.detach().clone()
    _td().all_reduce(buf, op=op)
    return buf


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The fabric-wide sum of ``x`` (one AllReduce, counted)."""
    return _all_reduce(x, _td().ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The fabric-wide max of ``x`` (one AllReduce, counted)."""
    return _all_reduce(x, _td().ReduceOp.MAX)


@dataclasses.dataclass
class Exchange:
    """The posted messages of one bidirectional exchange along one axis.

    ``wait`` returns ``(from_lo, from_hi)``: the lower neighbour's high slab
    and the upper neighbour's low slab, zeros at a fabric edge."""

    works: list
    bufs: dict
    sent: list
    like: torch.Tensor
    staged: bool

    def wait(self) -> tuple[torch.Tensor, torch.Tensor]:
        for w in self.works:
            w.wait()
        self.works, self.sent = [], []

        def take(side):
            buf = self.bufs.get(side)
            if buf is None:
                return torch.zeros(self.like.shape, dtype=self.like.dtype,
                                   device=self.like.device)
            t = buf.view(self.like.dtype).reshape(self.like.shape)
            if self.staged:
                _count_staged(buf.numel())
                t = t.to(self.like.device)
            return t

        return take("lo"), take("hi")


def exchange(lo: torch.Tensor, hi: torch.Tensor, lo_peer: int | None, hi_peer: int | None,
             axis: int) -> Exchange:
    """Post the exchange of ``lo`` (this rank's low slab) and ``hi`` (its
    high slab) along fabric axis ``axis``: receive the lower peer's high
    slab and the upper peer's low slab, send ours the other way.  The
    receives are posted before the sends, and one tag names each (axis,
    direction).  Counts 2 permutes whatever the rank's position."""
    obs_metrics.counter("comm.ppermute").inc(2)
    td = _td()
    staged = _staged(lo)
    nbytes = lo.numel() * lo.element_size()
    where = "cpu" if staged else lo.device
    up, down = 2 * axis, 2 * axis + 1          # tags: slabs travelling up / down the axis
    bufs, recvs, sends = {}, [], []
    if lo_peer is not None:
        bufs["lo"] = torch.empty(nbytes, dtype=torch.uint8, device=where)
        recvs.append(td.P2POp(td.irecv, bufs["lo"], lo_peer, tag=up))
    if hi_peer is not None:
        bufs["hi"] = torch.empty(nbytes, dtype=torch.uint8, device=where)
        recvs.append(td.P2POp(td.irecv, bufs["hi"], hi_peer, tag=down))
    if hi_peer is not None:
        sends.append(td.P2POp(td.isend, _wire(hi), hi_peer, tag=up))
    if lo_peer is not None:
        sends.append(td.P2POp(td.isend, _wire(lo), lo_peer, tag=down))
    ops = recvs + sends
    works = td.batch_isend_irecv(ops) if ops else []
    return Exchange(works, bufs, [op.tensor for op in sends], lo, staged)


# ---------------------------------------------------------------------------
# Whole blocks in and out of a run (uncounted: not part of the solve)
# ---------------------------------------------------------------------------

def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape and dtype on all ranks), in rank order,
    on ``t``'s device."""
    staged = _staged(t)
    wire = t.contiguous()
    wire = (wire.cpu() if staged else wire).reshape(-1).view(torch.uint8)
    if staged:
        _count_staged(wire.numel())
    outs = [torch.empty_like(wire) for _ in range(world_size())]
    _td().all_gather(outs, wire)
    res = [o.view(t.dtype).reshape(t.shape) for o in outs]
    if staged:
        _count_staged(wire.numel() * len(outs))
        res = [o.to(t.device) for o in res]
    return res


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    out = [None] * world_size()
    _td().all_gather_object(out, obj)
    return out


def scatter_from_root(blocks: list[torch.Tensor] | None, shape, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """Rank 0 hands each rank its block: rank 0 passes one host tensor per
    rank (``blocks``), the others ``None``; every rank gets its own block
    on ``device``.  No rank but 0 holds the others' blocks."""
    td = _td()
    nccl = backend() == "nccl"
    nbytes = int(torch.Size(shape).numel()) * torch.empty((), dtype=dtype).element_size()
    if rank() == 0:
        for r in range(1, world_size()):
            wire = blocks[r].to(dtype).contiguous().reshape(-1).view(torch.uint8)
            td.send(wire.to(device) if nccl else wire, r)
        return blocks[0].to(dtype).to(device)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=device if nccl else "cpu")
    td.recv(buf, 0)
    return buf.view(dtype).reshape(tuple(shape)).to(device)


def barrier() -> None:
    if world_size() > 1:
        _td().barrier()
