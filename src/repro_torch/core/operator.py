"""The LinearOperator layer: one protocol, interchangeable backends.

Counterpart of ``repro/core/operator.py``.  A :class:`LinearOperator` bundles
what a Krylov solver needs from the matrix side:

* ``apply(v)``            : u = A v (local to this rank);
* ``dots(pairs, policy)`` : fully reduced inner products;
* ``reduce_partials(ps)`` : the AllReduce of precomputed f32 local partials;
* ``reduce_max(x)``       : the fabric-wide max;
* ``fused``               : optional :class:`FusedOps`, the kernel passes that
  run one BiCGStab iteration as kernels plus 3 sync points;
* ``apply_axpy(alpha, r, s)``: optional ``A (r - st(alpha) s)`` on one
  block or a batch (``alpha`` then ``[B]``), the SpMV forming its own input
  (BiCGStab's second SpMV).

Backends (:data:`BACKENDS`):

* ``reference``: the dense-shift oracle in one address space;
* ``spmd``: the halo-exchange local apply with plain tensor ops;
* ``fused``: the halo exchange feeding the CUDA stencil kernel plus the
  fused_iter kernels (the counterpart of the JAX package's ``pallas``).

On a fabric of more ranks every AllReduce is one ``torch.distributed``
``all_reduce`` (``core/dist.py``); on the one-rank fabric it is the identity
and nothing is called.  Each AllReduce the reductions make (one per sync
point, or one per dot in the paper's separate schedule, and each
fabric-wide max) bumps the ``comm.allreduce`` counter of
:mod:`repro_torch.obs.metrics`, on one rank too: a count of what ran, so a
BiCGStab solve of n iterations reads 1 + 3n on every rank.  The JAX package
counts the ops of the lowered program instead (1 + 3).

Every backend takes a batch of right-hand sides: an operand with one axis
more than the coefficients (``nb = v.ndim - coeffs.ndim``) yields ``[B]``
dot partials, one sync point stacks them to ``[k, B]``, and the ``fused``
backend runs the batched kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import dist
from repro_torch.core.comm import OVERLAP, CommSchedule, get_schedule, scheduled_apply
from repro_torch.core.halo import FabricAxes
from repro_torch.core.precision import F32, Policy
from repro_torch.core.solvers.common import local_dots, local_partial
from repro_torch.core.stencil import StencilCoeffs, apply_ref
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class FusedOps:
    """The fused kernel passes (see ``kernels/fused_iter``); each returns its
    vector output(s) plus f32 local partials."""

    dot_partial: Callable      # (a, b) -> f32 partial <a, b>
    update_q_dots: Callable    # (alpha, r, s, y) -> (q, <q,y>, <y,y>)
    update_xr_dots: Callable   # (alpha, omega, x, p, q, y, r0) -> (x, r, <r0,r>, <r,r>)
    update_p: Callable         # (beta, omega, r, p, s) -> p


@dataclasses.dataclass(frozen=True)
class LinearOperator:
    """A rank-local view of ``A`` plus its communication schedule."""

    name: str
    coeffs: StencilCoeffs
    policy: Policy
    apply: Callable
    dots: Callable
    reduce_partials: Callable
    reduce_max: Callable
    fused: FusedOps | None = None
    schedule: CommSchedule = OVERLAP
    #: (alpha, r, s) -> A (r - st(alpha) s) for one block or a batch, or None
    apply_axpy: Callable | None = None

    @property
    def spec(self):
        return self.coeffs.spec

    def takes_axpy(self, v: torch.Tensor) -> bool:
        """Whether ``apply_axpy`` takes operands like ``v``: it is set and
        ``v`` is one block or a batch of them."""
        return self.apply_axpy is not None and v.ndim in (self.coeffs.ndim,
                                                          self.coeffs.ndim + 1)

    def with_apply(self, apply: Callable) -> "LinearOperator":
        """A copy with the SpMV swapped (how right preconditioning wraps); the
        copy has no ``apply_axpy``, which would skip the new SpMV."""
        return dataclasses.replace(self, apply=apply, apply_axpy=None)


def _identity_reduce(partials) -> torch.Tensor:
    return torch.stack([torch.as_tensor(p).to(torch.float32) for p in partials])


def _fabric_axis_names(fabric: FabricAxes) -> tuple[str, ...]:
    """Fabric axes that carry more than one rank (their reductions need a
    process group of the fabric's size)."""
    pairs = ((fabric.x, fabric.nx), (fabric.y, fabric.ny), (fabric.z, fabric.nz))
    names = tuple(a for a, n in pairs if a is not None and n > 1)
    if names:
        dist.check_fabric(fabric.size)
    return names


def _make_reductions(names: tuple[str, ...], fused_reductions: bool,
                     mesh_ndim: int | None = None):
    """(dots, reduce_partials, reduce_max) over the named fabric axes: one
    AllReduce per sync point (fused) or per dot (the paper's separate
    schedule).  The named axes span the whole process group, so each
    AllReduce runs over it; on one rank (no names) each is the identity.

    ``mesh_ndim`` enables the batch axis: operands of higher rank give
    per-RHS ``[B]`` partials, and a sync point reduces the stacked
    ``[k, B]`` array at once.  Every AllReduce bumps ``comm.allreduce``."""
    def psum(x):
        if names:
            return dist.all_reduce_sum(x)
        obs_metrics.counter("comm.allreduce").inc()
        return x

    if fused_reductions:
        def reduce_partials(ps):
            return psum(_identity_reduce(ps))
    else:
        def reduce_partials(ps):
            return torch.stack([psum(torch.as_tensor(p).to(torch.float32)) for p in ps])

    def dots(pairs, policy):
        return reduce_partials([local_partial(a, b, policy, mesh_ndim=mesh_ndim)
                                for a, b in pairs])

    def reduce_max(x):
        if names:
            return dist.all_reduce_max(x)
        obs_metrics.counter("comm.allreduce").inc()
        return x

    return dots, reduce_partials, reduce_max


def reference_operator(coeffs: StencilCoeffs, *, policy: Policy = F32,
                       schedule=None, **_unused) -> LinearOperator:
    """Single-address-space oracle: dense-shift apply, local reductions."""
    cf = coeffs.astype(policy.storage)
    return LinearOperator(
        name="reference", coeffs=cf, policy=policy,
        apply=lambda v: apply_ref(cf, v, policy=policy),
        dots=lambda pairs, policy: local_dots(pairs, policy, mesh_ndim=cf.ndim),
        reduce_partials=_identity_reduce,
        reduce_max=lambda x: x,
        schedule=get_schedule(schedule),
    )


def spmd_operator(coeffs: StencilCoeffs, fabric: FabricAxes | None = None, *,
                  policy: Policy = F32, schedule=None,
                  fused_reductions: bool = True, **_unused) -> LinearOperator:
    """Halo-exchange backend with plain tensor ops (the paper's scheme)."""
    fabric = fabric or FabricAxes()
    cf = coeffs.astype(policy.storage)
    sched = get_schedule(schedule)
    dots, reduce_partials, reduce_max = _make_reductions(
        _fabric_axis_names(fabric), fused_reductions, mesh_ndim=cf.ndim)
    return LinearOperator(
        name="spmd", coeffs=cf, policy=policy,
        apply=lambda v: scheduled_apply(cf, v, fabric, policy=policy, schedule=sched),
        dots=dots, reduce_partials=reduce_partials, reduce_max=reduce_max,
        schedule=sched,
    )


def fused_operator(coeffs: StencilCoeffs, fabric: FabricAxes | None = None, *,
                   policy: Policy = F32, schedule=None,
                   fused_reductions: bool = True, **_unused) -> LinearOperator:
    """Kernel backend: the halo exchange feeding the CUDA stencil kernel for
    the SpMV, and the fused_iter kernels for the vector updates and dot
    partials; one BiCGStab iteration is kernels plus 3 sync points.  An
    operand with a leading batch axis runs the batched kernels, all right-
    hand sides in one launch.  On CPU tensors every kernel takes its plain
    version.  The stencil kernel cuts each launch by its own plan
    (``kernels/stencil_nd/kernel.py:launch_plan``); nothing is looked up here.

    ``apply_axpy`` is the stencil kernel's form that stages its own input
    ``r - st(alpha) s`` (``kernels/stencil_nd/kernel.py:stencil_nd_axpy``,
    and ``stencil_nd_batched_axpy`` for a batch, one ``alpha`` a right-hand
    side), set where that input need not exist in memory: one rank (no halo
    to exchange), the family's unit diagonal, and a Z the kernel's 16-B
    staging takes."""
    from repro_torch.kernels.fused_iter import dot_mixed, update_p, update_q_dots, update_xr_dots
    from repro_torch.kernels.stencil_nd.kernel import (
        axpy_staged, stencil_nd_axpy, stencil_nd_batched_axpy,
    )
    from repro_torch.kernels.stencil_nd.ops import fused_local_apply

    fabric = fabric or FabricAxes()
    cf = coeffs.astype(policy.storage)
    sched = get_schedule(schedule)
    names = _fabric_axis_names(fabric)
    _dots, reduce_partials, reduce_max = _make_reductions(names, fused_reductions,
                                                          mesh_ndim=cf.ndim)

    cf_unit = StencilCoeffs(cf.diags)   # the kernel's unit-diagonal contract
    base_apply = lambda v: fused_local_apply(cf_unit, v, fabric, policy=policy,
                                             schedule=sched)
    if cf.diag is None:
        apply = base_apply
    else:
        # The kernel assumes the family's unit main diagonal; a raw
        # (non-normalized) operator adds its (d - 1) deviation elementwise.
        c = policy.compute
        dcorr = cf.diag.to(c) - torch.ones((), dtype=c, device=cf.diag.device)

        def apply(v):
            return (base_apply(v).to(c) + dcorr * v.to(c)).to(policy.storage)

    apply_axpy = None
    if not names and cf.diag is None and axpy_staged(cf.shape, policy.storage.itemsize):
        spec = cf.spec
        cf_list = [cf.diags[n] for n in spec.names]

        def apply_axpy(alpha, r, s):
            form = stencil_nd_batched_axpy if r.ndim > cf.ndim else stencil_nd_axpy
            return form(alpha, r.contiguous(), s.contiguous(), cf_list, spec.offsets,
                        radius=spec.radius, accum_dtype=policy.compute)

    batched = lambda a: a.ndim > cf.ndim
    dot_partial = lambda a, b: dot_mixed(a, b, batched=batched(a))
    return LinearOperator(
        name="fused", coeffs=cf, policy=policy,
        apply=apply,
        dots=lambda pairs, policy: reduce_partials([dot_partial(a, b) for a, b in pairs]),
        reduce_partials=reduce_partials,
        reduce_max=reduce_max,
        schedule=sched,
        apply_axpy=apply_axpy,
        fused=FusedOps(
            dot_partial=dot_partial,
            update_q_dots=lambda alpha, r, s, y: update_q_dots(
                alpha, r, s, y, batched=batched(r)),
            update_xr_dots=lambda alpha, omega, x, p, q, y, r0: update_xr_dots(
                alpha, omega, x, p, q, y, r0, batched=batched(x)),
            update_p=lambda beta, omega, r, p, s: update_p(
                beta, omega, r, p, s, batched=batched(r))),
    )


#: backend name -> constructor; launch/solve.py keys off this.
BACKENDS = {
    "reference": reference_operator,
    "spmd": spmd_operator,
    "fused": fused_operator,
}


def make_operator(backend: str, coeffs: StencilCoeffs, fabric: FabricAxes | None = None,
                  *, policy: Policy = F32, **kwargs) -> LinearOperator:
    """Build a backend by name; the reference backend ignores ``fabric``."""
    try:
        ctor = BACKENDS[backend]
    except KeyError:
        raise KeyError(f"unknown backend {backend!r}; have {sorted(BACKENDS)}") from None
    obs_metrics.counter(f"operator.build.{backend}").inc()
    with obs_trace.span("operator.build", backend=backend, stencil=coeffs.spec.name,
                        policy=policy.name):
        if backend == "reference":
            return ctor(coeffs, policy=policy, **kwargs)
        return ctor(coeffs, fabric, policy=policy, **kwargs)
