"""Halo-exchange SpMV on the rank fabric (paper §IV-1, Figs. 3-5), depth-r.

Counterpart of ``repro/core/halo.py``.  A rank owns a ``(bx, by, Z)``
sub-volume and needs a depth-r halo of its neighbours' faces before the
stencil can be applied at its boundary.  Each split fabric axis exchanges a
slab of thickness r per direction (``core/dist.py:exchange``, two counted
permutes); unsplit axes and fabric edges are zero-padded, the global
zero-Dirichlet boundary.  Star stencils exchange the axes independently on
the raw block, so all messages are posted at once and the corner halos stay
zero (a star never reads them).  Box stencils exchange the axes in
sequence on the progressively padded block, so halos received on earlier
axes ride along to the diagonal neighbours.  Each slab carries all B
right-hand sides in one message.

On a one-rank fabric nothing travels: :func:`gather_halo` is the zero pad
and no ``torch.distributed`` call is made.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import dist
from repro_torch.core.precision import F32, Policy
from repro_torch.core.stencil import StencilCoeffs, _shift_nd, name_offset


@dataclasses.dataclass(frozen=True)
class FabricAxes:
    """Names/extents of the rank-grid axes carrying the stencil's X, Y (and
    Z) dims, and this rank's coordinates ``(ix, iy, iz)`` on them."""

    x: str = "data"
    nx: int = 1
    y: str = "model"
    ny: int = 1
    z: str | None = None          # a third axis slabs Z when present
    nz: int = 1
    coords: tuple[int, int, int] = (0, 0, 0)

    @classmethod
    def from_mesh(cls, mesh) -> "FabricAxes":
        """From a :class:`~repro_torch.launch.mesh.RankMesh` (or anything with
        a ``shape`` mapping axis name -> extent, and optionally ``coords``)."""
        ax = dict(mesh.shape)
        c = dict(getattr(mesh, "coords", {}))
        return cls(x="data", nx=ax["data"], y="model", ny=ax["model"],
                   z="pod" if "pod" in ax else None, nz=ax.get("pod", 1),
                   coords=(c.get("data", 0), c.get("model", 0), c.get("pod", 0)))

    def split_info(self, ndim: int = 3) -> list[tuple[int, str | None, int]]:
        """(mesh axis, fabric axis name or None, fabric extent) per dimension."""
        info = [(0, self.x, self.nx), (1, self.y, self.ny)]
        if ndim == 3:
            info.append((2, self.z, self.nz))
        return info

    @property
    def size(self) -> int:
        return self.nx * self.ny * self.nz

    def rank_at(self, coords: tuple[int, int, int]) -> int:
        """The rank at fabric coordinates ``(ix, iy, iz)`` (the mesh's
        row-major (pod, data, model) order)."""
        ix, iy, iz = coords
        return (iz * self.nx + ix) * self.ny + iy

    def at_rank(self, rank: int) -> "FabricAxes":
        """This fabric as rank ``rank`` sees it (the inverse of :meth:`rank_at`)."""
        coords = ((rank // self.ny) % self.nx, rank % self.ny, rank // (self.nx * self.ny))
        return dataclasses.replace(self, coords=coords)

    def peers(self, dim: int) -> tuple[int | None, int | None]:
        """The ranks below and above this one along mesh dimension ``dim``
        (None at a fabric edge)."""
        n = (self.nx, self.ny, self.nz)[dim]
        c = self.coords[dim]

        def at(k):
            cc = list(self.coords)
            cc[dim] = k
            return self.rank_at(tuple(cc))

        return (at(c - 1) if c > 0 else None), (at(c + 1) if c < n - 1 else None)


def _take_slab(v: torch.Tensor, axis: int, sl: slice) -> torch.Tensor:
    return v[tuple(sl if i == axis else slice(None) for i in range(v.ndim))]


def _pad_axis(v: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    pad = [0, 0] * v.ndim
    pad[2 * (v.ndim - 1 - axis):2 * (v.ndim - 1 - axis) + 2] = [r, r]
    return F.pad(v, pad)


class HaloPost:
    """A depth-r halo exchange whose messages are posted; :meth:`wait`
    returns the r-padded block with every halo filled.

    Star stencils post every split axis at once.  Box stencils run the axes
    in mesh order on the progressively padded block: the first split axis
    is posted here, and each later one after the previous has arrived."""

    def __init__(self, v: torch.Tensor, fabric: FabricAxes, radius: int, *,
                 corners: bool, n_batch: int):
        r, nb = radius, n_batch
        self.v, self.r, self.nb, self.corners = v, r, nb, corners
        self.splits = [(dim, dim + nb, name is not None and n > 1)
                       for dim, name, n in fabric.split_info(v.ndim - nb)]
        for dim, axis, split in self.splits:
            if split and v.shape[axis] < r:
                raise ValueError(
                    f"halo depth {r} exceeds the local block extent {v.shape[axis]} "
                    f"on axis {axis}; use fewer shards or a larger mesh")
        dist.check_fabric(fabric.size)
        self.fabric = fabric
        if not corners:
            self.posted = [(dim, axis, self._post(v, dim, axis))
                           for dim, axis, split in self.splits if split]
        else:
            self.todo = list(self.splits)
            self.vp = v
            self.inflight = self._advance()

    def _post(self, v: torch.Tensor, dim: int, axis: int) -> dist.Exchange:
        m, r = v.shape[axis], self.r
        lo_peer, hi_peer = self.fabric.peers(dim)
        return dist.exchange(_take_slab(v, axis, slice(0, r)),
                             _take_slab(v, axis, slice(m - r, None)), lo_peer, hi_peer, dim)

    def _advance(self):
        """Box order: pad unsplit axes until a split one, then post it."""
        while self.todo:
            dim, axis, split = self.todo.pop(0)
            if not split:
                self.vp = _pad_axis(self.vp, axis, self.r)
                continue
            return axis, self._post(self.vp, dim, axis)
        return None

    def wait(self) -> torch.Tensor:
        r, nb, v = self.r, self.nb, self.v
        if not self.corners:
            vp = F.pad(v, (r, r) * (v.ndim - nb))
            for _, axis, ex in self.posted:
                from_lo, from_hi = ex.wait()
                idx = lambda sl: tuple(
                    slice(None) if i < nb else sl if i == axis
                    else slice(r, r + v.shape[i]) for i in range(v.ndim))
                vp[idx(slice(0, r))] = from_lo
                vp[idx(slice(r + v.shape[axis], None))] = from_hi
            return vp
        while self.inflight is not None:
            axis, ex = self.inflight
            from_lo, from_hi = ex.wait()
            self.vp = torch.cat([from_lo, self.vp, from_hi], dim=axis)
            self.inflight = self._advance()
        return self.vp


def is_split(fabric: FabricAxes, ndim: int) -> bool:
    """Whether any of the ``ndim`` mesh axes is split over more than one rank."""
    return any(name is not None and n > 1 for _, name, n in fabric.split_info(ndim))


def gather_halo(v: torch.Tensor, fabric: FabricAxes, radius: int = 1, *,
                corners: bool = False, n_batch: int = 0) -> torch.Tensor:
    """The local block padded by ``radius`` on every mesh axis, halos filled.

    Split axes exchange depth-r slabs with the neighbouring ranks (star:
    independently, corners zero; box, ``corners=True``: in sequence, corners
    carried); unsplit axes and fabric edges are the zero pad.  On a one-rank
    fabric this is the zero pad on all sides.  ``n_batch`` leading axes are
    never padded and ride every message whole.
    """
    r = radius
    if not is_split(fabric, v.ndim - n_batch):
        return F.pad(v, (r, r) * (v.ndim - n_batch))
    return HaloPost(v, fabric, r, corners=corners, n_batch=n_batch).wait()


def _window(vp: torch.Tensor, off: tuple[int, ...], shape: tuple[int, ...],
            r: int, n_batch: int = 0) -> torch.Tensor:
    """The ``shape``-sized window of the r-padded block shifted by ``off``."""
    return vp[(slice(None),) * n_batch
              + tuple(slice(r + o, r + o + n) for o, n in zip(off, shape))]


def padded_apply(coeffs: StencilCoeffs, vp: torch.Tensor, shape: tuple[int, ...], *,
                 policy: Policy = F32,
                 region: tuple[slice, ...] | None = None) -> torch.Tensor:
    """u = A v (compute dtype) from an r-padded local block, halos in place.

    ``region`` restricts the computation to a sub-box of the local block
    (the overlap schedule's boundary ring).
    """
    spec = coeffs.spec
    c = policy.compute
    nb = vp.ndim - coeffs.ndim
    mesh_shape = tuple(shape[len(shape) - coeffs.ndim:])
    reg = region if region is not None else tuple(slice(None) for _ in mesh_shape)
    vreg = (slice(None),) * nb + tuple(reg)
    sub = lambda off: _window(vp, off, mesh_shape, spec.radius, nb)[vreg].to(c)
    center = sub((0,) * coeffs.ndim)
    u = center if coeffs.diag is None else coeffs.diag[reg].to(c) * center
    for name, cf in coeffs.ordered_items():   # canonical order
        u = u + cf[reg].to(c) * sub(name_offset(name, coeffs.ndim))
    return u


def interior_apply(coeffs: StencilCoeffs, v: torch.Tensor, *,
                   policy: Policy = F32) -> torch.Tensor:
    """Zero-Dirichlet local apply in compute dtype: reads nothing a neighbor
    sends, so the overlap schedule runs it while the halo is in flight."""
    c = policy.compute
    nb = v.ndim - coeffs.ndim
    vc = v.to(c)
    u = vc if coeffs.diag is None else coeffs.diag.to(c) * vc
    for name, cf in coeffs.ordered_items():   # canonical order
        u = u + cf.to(c) * _shift_nd(vc, (0,) * nb + name_offset(name, coeffs.ndim))
    return u


def local_apply(coeffs: StencilCoeffs, v: torch.Tensor, fabric: FabricAxes, *,
                policy: Policy = F32, schedule=None) -> torch.Tensor:
    """This rank's share of u = A v with the depth-r halo, under a
    communication schedule (``core.comm.SCHEDULES``)."""
    from repro_torch.core.comm import get_schedule, scheduled_apply

    return scheduled_apply(coeffs, v, fabric, policy=policy,
                           schedule=get_schedule(schedule))


def block_slices(fabric: FabricAxes, shape: tuple[int, ...]) -> tuple[slice, ...]:
    """This rank's slices of a global mesh-shaped array (X, Y[, Z]); every
    split extent must divide by its fabric extent."""
    out = []
    for (dim, name, n), m in zip(fabric.split_info(len(shape)), shape):
        if m % n:
            raise ValueError(f"mesh extent {m} on axis {dim} does not divide by the "
                             f"fabric's {n} ranks there")
        b = m // n
        c = fabric.coords[dim]
        out.append(slice(c * b, (c + 1) * b))
    return tuple(out)


def local_block(t: torch.Tensor, fabric: FabricAxes, n_batch: int = 0) -> torch.Tensor:
    """This rank's block of a global array (a contiguous copy where the
    slice is not contiguous); ``n_batch`` leading axes are kept whole."""
    sl = block_slices(fabric, tuple(t.shape[n_batch:]))
    return t[(slice(None),) * n_batch + sl].contiguous()


def local_coeffs(coeffs: StencilCoeffs, fabric: FabricAxes) -> StencilCoeffs:
    """This rank's block of global coefficients."""
    return StencilCoeffs({n: local_block(c, fabric) for n, c in coeffs.diags.items()},
                         None if coeffs.diag is None else local_block(coeffs.diag, fabric))


def gather_blocks(u: torch.Tensor, fabric: FabricAxes, n_batch: int = 0) -> torch.Tensor:
    """The global array from every rank's block, on every rank (the
    counterpart of a ``shard_map`` output with the fabric's spec)."""
    blocks = dist.all_gather(u)
    mesh = tuple(u.shape[n_batch:])
    full = tuple(u.shape[:n_batch]) + tuple(
        m * n for m, (_, _, n) in zip(mesh, fabric.split_info(len(mesh))))
    out = torch.empty(full, dtype=u.dtype, device=u.device)
    for r, block in enumerate(blocks):
        out[(slice(None),) * n_batch + block_slices(fabric.at_rank(r), full[n_batch:])] = block
    return out


def global_apply(mesh, coeffs: StencilCoeffs, v: torch.Tensor, *, policy: Policy = F32,
                 schedule=None) -> torch.Tensor:
    """One SpMV on global arrays over the rank mesh.  On the one-rank
    fabric the global array is the local block; on more ranks every rank
    takes its block by its coordinates, applies with the halo exchange, and
    the blocks are gathered back to every rank."""
    fabric = FabricAxes.from_mesh(mesh)
    if fabric.size == 1:
        return local_apply(coeffs, v, fabric, policy=policy, schedule=schedule)
    dist.check_fabric(fabric.size)
    nb = v.ndim - coeffs.ndim
    u = local_apply(local_coeffs(coeffs, fabric), local_block(v, fabric, nb), fabric,
                    policy=policy, schedule=schedule)
    return gather_blocks(u, fabric, nb)
