"""Wrappers around the stencil kernel: argument order, and the drop-in
local apply that pairs the kernel with the depth-r halo exchange.

Counterpart of ``repro/kernels/stencil_nd/ops.py``.  An iterate with one
leading axis more than the coefficients is a batch of right-hand sides
(``nb = v.ndim - coeffs.ndim``, as in the JAX package), and the batched
kernel runs them all in one launch.  A zero-Dirichlet apply hands the kernel
the bare block, whose zero halo it stages itself (the JAX wrapper pads
first); only an exchanged block, with its neighbours' halo, is padded.
Every launch is cut by the kernel's own plan
(``kernels/stencil_nd/kernel.py:launch_plan``), from the shape it is given.
"""

from __future__ import annotations

import torch

from repro_torch.core.stencil import StencilCoeffs, StencilSpec
from repro_torch.kernels.stencil_nd.kernel import stencil_nd, stencil_nd_batched


def _spec_order(coeffs: StencilCoeffs, spec: StencilSpec) -> list[torch.Tensor]:
    """Diagonals in the spec's canonical order (the kernel's argument contract)."""
    return [coeffs.diags[n] for n in spec.names]


def _require_unit_diag(coeffs: StencilCoeffs) -> None:
    if coeffs.diag is not None:
        raise NotImplementedError(
            "the stencil kernel assumes the family's unit diagonal; raw operators "
            "go through core.operator.fused_operator, which adds the diagonal "
            "deviation outside the kernel")


def _batch_rank(v: torch.Tensor, coeffs: StencilCoeffs) -> int:
    """The iterate's batch rank (0 or 1) against 3-D coefficient fields."""
    nb = v.ndim - coeffs.ndim
    if coeffs.ndim != 3 or nb not in (0, 1):
        raise ValueError(f"the stencil kernel takes a 3-D block or a batch of them; got "
                         f"{tuple(v.shape)} against {coeffs.ndim}-D coefficients")
    return nb


def _kernel(nb: int):
    """The unbatched or the batched kernel wrapper."""
    return stencil_nd_batched if nb else stencil_nd


def stencil_apply(coeffs: StencilCoeffs, v: torch.Tensor, *,
                  spec: StencilSpec | None = None,
                  accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """u = A v on a local block, zero-Dirichlet at the block edges, any spec."""
    _require_unit_diag(coeffs)
    nb = _batch_rank(v, coeffs)
    spec = spec or coeffs.spec
    return _kernel(nb)(v.contiguous(), _spec_order(coeffs, spec), spec.offsets,
                       radius=spec.radius, accum_dtype=accum_dtype)


def ring_patch_apply(exchange, cf_list: list[torch.Tensor], spec: StencilSpec,
                     u: torch.Tensor, fabric, *,
                     accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The overlap epilogue: re-run the kernel on the exchanged depth-r ring
    slabs and overwrite the ring of ``u`` in place (``u`` is the interior
    kernel's fresh output).  One extra launch per boundary region, each
    planned from its slab's shape; none on a one-rank fabric."""
    from repro_torch.core.comm import boundary_regions

    r = spec.radius
    pre = (slice(None),) * exchange.n_batch
    for reg in boundary_regions(exchange.shape, fabric, r):
        lo_hi = [(sl.start or 0, exchange.shape[i] if sl.stop is None else sl.stop)
                 for i, sl in enumerate(reg)]
        sub_vp = exchange.padded[pre + tuple(slice(lo, hi + 2 * r) for lo, hi in lo_hi)]
        u[pre + reg] = _kernel(exchange.n_batch)(
            sub_vp.contiguous(), [c[reg].contiguous() for c in cf_list], spec.offsets,
            radius=r, accum_dtype=accum_dtype)
    return u


def fused_local_apply(coeffs: StencilCoeffs, v: torch.Tensor, fabric, *, policy,
                      schedule=None) -> torch.Tensor:
    """Drop-in for ``core.halo.local_apply``: the depth-r halo exchange feeding
    the stencil kernel, under either communication schedule (counterpart of
    ``pallas_local_apply``).

    ``blocking``: the kernel runs once over the assembled halo'd block.
    ``overlap``: the exchange starts first; the kernel runs on the bare
    block (the interior, which waits on no neighbor; the kernel stages the
    zero halo, so no padded copy is made), and the boundary ring is patched
    from the exchanged block.  Both forms accumulate the same
    canonical-order terms, so they agree bitwise.  Products and sums run in
    ``policy.compute``: under ``bf16_mixed`` the SpMV accumulates in bf16.
    """
    from repro_torch.core import comm

    _require_unit_diag(coeffs)
    spec = coeffs.spec
    r = spec.radius
    cf = coeffs.astype(policy.storage)
    vs = v.to(policy.storage).contiguous()      # the kernel reads the bare block in place
    launch = _kernel(_batch_rank(vs, cf))
    cf_list = _spec_order(cf, spec)

    def kernel(block):          # bare (the interior) or padded (the assembled halo)
        return launch(block, cf_list, spec.offsets, radius=r, accum_dtype=policy.compute)

    def patch_ring(exchange, u):
        return ring_patch_apply(exchange, cf_list, spec, u, fabric,
                                accum_dtype=policy.compute)

    return comm.scheduled_apply(
        cf, vs, fabric, policy=policy, schedule=schedule,
        full_fn=kernel,
        interior_fn=kernel,
        patch_fn=patch_ring)
