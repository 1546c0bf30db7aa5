"""Halo-exchange SpMV on the rank fabric (paper §IV-1, Figs. 3-5), depth-r.

Counterpart of ``repro/core/halo.py``.  A rank owns a ``(bx, by, Z)``
sub-volume and needs a depth-r halo of its neighbors' faces before the
stencil can be applied at its boundary.  This slice of the port runs on a
one-rank fabric: every axis is unsplit, so :func:`gather_halo` is the zero
pad (the global zero-Dirichlet boundary).  An axis split over more than one
rank raises until the ``torch.distributed`` exchange lands.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.precision import F32, Policy
from repro_torch.core.stencil import StencilCoeffs, _shift_nd, name_offset


@dataclasses.dataclass(frozen=True)
class FabricAxes:
    """Names/extents of the rank-grid axes carrying the stencil's X, Y (and Z) dims."""

    x: str = "data"
    nx: int = 1
    y: str = "model"
    ny: int = 1
    z: str | None = None          # a third axis slabs Z when present
    nz: int = 1

    @classmethod
    def from_mesh(cls, mesh) -> "FabricAxes":
        """From a :class:`~repro_torch.launch.mesh.RankMesh` (or anything with
        a ``shape`` mapping axis name -> extent)."""
        ax = dict(mesh.shape)
        return cls(x="data", nx=ax["data"], y="model", ny=ax["model"],
                   z="pod" if "pod" in ax else None, nz=ax.get("pod", 1))

    def split_info(self, ndim: int = 3) -> list[tuple[int, str | None, int]]:
        """(mesh axis, fabric axis name or None, fabric extent) per dimension."""
        info = [(0, self.x, self.nx), (1, self.y, self.ny)]
        if ndim == 3:
            info.append((2, self.z, self.nz))
        return info

    @property
    def size(self) -> int:
        return self.nx * self.ny * self.nz


def _check_one_rank(fabric: FabricAxes, ndim: int) -> None:
    for _, name, n in fabric.split_info(ndim):
        if name is not None and n > 1:
            raise NotImplementedError("multi-rank halo exchange: next slice")


def gather_halo(v: torch.Tensor, fabric: FabricAxes, radius: int = 1, *,
                corners: bool = False, n_batch: int = 0) -> torch.Tensor:
    """The local block padded by ``radius`` on every mesh axis, halos filled.

    On the one-rank fabric every axis is unsplit, so the halo is the zero
    pad on all sides (corners included, which is what a box stencil's
    corner-carrying exchange delivers there too).  ``n_batch`` leading axes
    are never padded.
    """
    del corners   # with no split axis, star and box halos are the same zero pad
    _check_one_rank(fabric, v.ndim - n_batch)
    r = radius
    return F.pad(v, (r, r) * (v.ndim - n_batch))


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


def global_apply(mesh, coeffs: StencilCoeffs, v: torch.Tensor, *, policy: Policy = F32,
                 schedule=None) -> torch.Tensor:
    """One SpMV on global arrays over the rank mesh.  On the one-rank
    fabric the global array is the local block; a mesh of more ranks raises
    until the ``torch.distributed`` slice lands."""
    fabric = FabricAxes.from_mesh(mesh)
    if fabric.size > 1:
        raise NotImplementedError("multi-rank global apply (torch.distributed): next slice")
    return local_apply(coeffs, v, fabric, policy=policy, schedule=schedule)
