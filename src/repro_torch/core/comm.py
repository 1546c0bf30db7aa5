"""Communication scheduling: when the halo exchange runs relative to compute.

Counterpart of ``repro/core/comm.py``.

* ``blocking`` assembles the full halo'd block, then computes every term
  from it (the paper's streaming form).
* ``overlap`` starts the exchange first, computes the interior (which needs
  no halo) while it is in flight, then patches only the depth-r boundary
  ring.  Both accumulate the same terms in the same canonical order, so they
  agree bitwise.

On more ranks the overlap schedule posts the halo messages
(:func:`start_halo_exchange`), computes the interior while they travel,
and waits only when it patches the boundary ring.  On the one-rank fabric
there is no boundary ring (:func:`boundary_regions` is empty), so both
schedules reach the same kernel on the zero-padded block, and nothing is
sent.

Observability, at the JAX package's sites: spans ``comm.halo.issue``,
``.blocking``, ``.interior`` and ``.ring``, and the
``comm.halo_exchanges`` counter.  In eager PyTorch they fire on every SpMV
(the JAX package's fire once per trace), and their time is the host's.
``.issue`` and ``.ring`` open only where an axis is split: on the one-rank
fabric they would wrap no work (nothing is posted, no ring is patched).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.halo import (
    FabricAxes, HaloPost, gather_halo, interior_apply, is_split, padded_apply,
)
from repro_torch.core.precision import F32, Policy
from repro_torch.core.stencil import StencilCoeffs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """A named policy for ordering the halo exchange against compute."""

    name: str
    overlap_halo: bool

    def __str__(self) -> str:
        return self.name


BLOCKING = CommSchedule("blocking", overlap_halo=False)
OVERLAP = CommSchedule("overlap", overlap_halo=True)

#: schedule name -> schedule; the CLI keys off this.
SCHEDULES = {s.name: s for s in (BLOCKING, OVERLAP)}


def get_schedule(schedule, default: CommSchedule = OVERLAP) -> CommSchedule:
    """Normalize a name / CommSchedule / None."""
    if schedule is None:
        return default
    if isinstance(schedule, CommSchedule):
        return schedule
    try:
        return SCHEDULES[schedule]
    except KeyError:
        raise KeyError(f"unknown comm schedule {schedule!r}; have {sorted(SCHEDULES)}") from None


@dataclasses.dataclass(frozen=True)
class HaloExchange:
    """A started depth-r halo exchange.

    ``padded`` is the r-padded block with its halos in place.  With a split
    axis the messages were posted when the exchange started (``post``), and
    the first read of ``padded`` waits on them.  On the one-rank fabric nothing
    travels, so the block is built on its first read: the overlap schedule
    with no boundary ring never reads it, and eager PyTorch (unlike XLA)
    would not drop an unread copy.
    """

    v: torch.Tensor
    fabric: FabricAxes
    radius: int
    corners: bool = False
    n_batch: int = 0
    post: HaloPost | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        """The unpadded local mesh block shape."""
        return tuple(self.v.shape[self.n_batch:])

    @functools.cached_property
    def padded(self) -> torch.Tensor:
        if self.post is not None:
            return self.post.wait()
        return gather_halo(self.v, self.fabric, self.radius,
                           corners=self.corners, n_batch=self.n_batch)


def start_halo_exchange(v: torch.Tensor, fabric: FabricAxes, radius: int, *,
                        corners: bool = False, n_batch: int = 0) -> HaloExchange:
    """Start the depth-r exchange (post its messages where an axis is split)
    and return its handle.  With no split axis nothing is posted, and no
    ``comm.halo.issue`` span is opened."""
    obs_metrics.counter("comm.halo_exchanges").inc()
    if not is_split(fabric, v.ndim - n_batch):
        return HaloExchange(v, fabric, radius, corners, n_batch)
    with obs_trace.span("comm.halo.issue", radius=radius, n_batch=n_batch):
        post = HaloPost(v, fabric, radius, corners=corners, n_batch=n_batch)
        return HaloExchange(v, fabric, radius, corners, n_batch, post=post)


def boundary_regions(shape: tuple[int, ...], fabric: FabricAxes,
                     radius: int) -> list[tuple[slice, ...]]:
    """The depth-r slabs of the local block that read halo values: two per
    split fabric axis (none on a one-rank fabric).  Slabs of different axes
    overlap at edges and corners; patching them in turn writes the same
    values there."""
    regions = []
    for axis, name, n in fabric.split_info(len(shape)):
        if name is None or n == 1:
            continue
        for side in (slice(0, radius), slice(shape[axis] - radius, None)):
            regions.append(tuple(side if i == axis else slice(None)
                                 for i in range(len(shape))))
    return regions


def boundary_ring_apply(coeffs: StencilCoeffs, exchange: HaloExchange,
                        u: torch.Tensor, fabric: FabricAxes, *,
                        policy: Policy = F32) -> torch.Tensor:
    """Overwrite the boundary ring of ``u`` with halo-correct values,
    recomputed from the exchanged block in the same term order."""
    pre = (slice(None),) * exchange.n_batch
    for reg in boundary_regions(exchange.shape, fabric, exchange.radius):
        u = u.clone()
        u[pre + reg] = padded_apply(coeffs, exchange.padded, exchange.shape,
                                    policy=policy, region=reg).to(u.dtype)
    return u


def scheduled_apply(coeffs: StencilCoeffs, v: torch.Tensor, fabric: FabricAxes, *,
                    policy: Policy = F32, schedule: CommSchedule | str | None = None,
                    full_fn=None, interior_fn=None, patch_fn=None) -> torch.Tensor:
    """u = A v on the local shard under the given communication schedule.

    The one place the schedule's structure lives; backends customize how each
    piece computes through hooks that default to the plain shifted-window
    applies:

    * ``full_fn(vp) -> u``: the blocking apply over the assembled halo'd block;
    * ``interior_fn(v) -> u``: the zero-Dirichlet apply run while the halo is
      in flight;
    * ``patch_fn(exchange, u) -> u``: overwrite the boundary ring from the
      exchanged block.

    For bitwise identity across schedules a backend's hooks accumulate terms
    in the canonical order (``StencilCoeffs.ordered_items``).
    """
    spec = coeffs.spec
    r = spec.radius
    nb = v.ndim - coeffs.ndim
    sched = get_schedule(schedule)

    if not sched.overlap_halo:
        with obs_trace.span("comm.halo.blocking", stencil=spec.name):
            obs_metrics.counter("comm.halo_exchanges").inc()
            vp = gather_halo(v, fabric, r, corners=spec.needs_corners, n_batch=nb)
            if full_fn is not None:
                return full_fn(vp)
            return padded_apply(coeffs, vp, tuple(v.shape), policy=policy).to(policy.storage)

    exchange = start_halo_exchange(v, fabric, r, corners=spec.needs_corners, n_batch=nb)
    with obs_trace.span("comm.halo.interior", stencil=spec.name):
        u = interior_apply(coeffs, v, policy=policy) if interior_fn is None else interior_fn(v)

    def patch(u):
        if patch_fn is not None:
            return patch_fn(exchange, u)
        return boundary_ring_apply(coeffs, exchange, u, fabric,
                                   policy=policy).to(policy.storage)

    if exchange.post is None:           # no split axis: no boundary region to patch
        return patch(u)
    with obs_trace.span("comm.halo.ring", stencil=spec.name):
        return patch(u)
