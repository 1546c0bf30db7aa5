"""BiCGStab's second SpMV with its input unformed: ``A (r - st(alpha) s)``.

The stencil kernel's axpy form (``kernels/stencil_nd/kernel.py:
stencil_nd_axpy``) stages ``q = r - st(alpha) s`` itself, and the fused
operator offers it as ``apply_axpy`` where ``q`` need not exist in memory
(one rank, the family's unit diagonal, Z a whole number of 16-B vectors).
The CUDA form runs only on the card (``chip_smoke.py`` holds it bit for bit
against K1 on the plain ``q_in``); here the wrapper sees CPU tensors and
takes its plain version, which the solver's paths must match bit for bit.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_port import assert_bitwise  # noqa: E402
from repro_torch.core import dist, operator, precision, stencil  # noqa: E402
from repro_torch.core.halo import FabricAxes  # noqa: E402
from repro_torch.core.precond import build_precond, get_precond_config, wrap_right  # noqa: E402
from repro_torch.core.solvers import get_solver  # noqa: E402
from repro_torch.core.solvers.bicgstab import bicgstab_fused_loop  # noqa: E402
from repro_torch.kernels.stencil_nd.kernel import (  # noqa: E402
    axpy_staged, launch_plan, stencil_nd_axpy,
)
from repro_torch.kernels.stencil_nd.ref import stencil_nd_ref  # noqa: E402

_T = {"f32": torch.float32, "bf16": torch.bfloat16}
SHAPE = (6, 7, 16)          # Z a whole number of 16-B vectors in f32 and bf16


@pytest.mark.parametrize("storage,accum", [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32")])
@pytest.mark.parametrize("specname", ["star7", "star13", "star25", "box27"])
def test_axpy_plain_version_is_k1_on_q_in(specname, storage, accum):
    """The wrapper's plain version: the plain K1 on ``r - alpha.to(dtype) *
    s``, bit for bit, for every family spec; alpha rounded to storage first."""
    spec = stencil.get_spec(specname)
    dt = _T[storage]
    g = torch.Generator().manual_seed(21)
    r, s = (torch.randn(SHAPE, generator=g).to(dt) for _ in range(2))
    cfs = [(0.2 * torch.randn(SHAPE, generator=g)).to(dt) for _ in spec.offsets]
    alpha = torch.tensor(0.6180339)        # not a bf16 value: the rounding shows
    got = stencil_nd_axpy(alpha, r, s, cfs, spec.offsets, radius=spec.radius,
                          accum_dtype=_T[accum])
    want = stencil_nd_ref(r - alpha.to(dt) * s, cfs, spec.offsets, accum_dtype=_T[accum])
    assert got.dtype == dt and tuple(got.shape) == SHAPE
    assert_bitwise(got, want)


def test_axpy_wrapper_refuses_mismatched_operands():
    spec = stencil.STAR7
    cfs = [torch.zeros(SHAPE)] * spec.n_offsets
    with pytest.raises(ValueError, match="one shape and dtype"):
        stencil_nd_axpy(torch.tensor(1.0), torch.zeros(SHAPE), torch.zeros(SHAPE[:2] + (8,)),
                        cfs, spec.offsets, radius=1)
    with pytest.raises(ValueError, match="bare"):        # the padded block is not taken
        padded = tuple(n + 2 for n in SHAPE)
        stencil_nd_axpy(torch.tensor(1.0), torch.zeros(padded), torch.zeros(padded), cfs,
                        spec.offsets, radius=1)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("specname", ["star7", "star25", "box27"])
def test_axpy_plan_holds_one_more_plane(specname, itemsize):
    """The axpy form's shared memory is the ring plus one plane of s; its
    tiles and segments are the bare form's."""
    spec = stencil.get_spec(specname)
    shape = (64, 40, 256)
    k1 = launch_plan(shape, 1, spec.n_offsets, spec.radius, itemsize)
    ax = launch_plan(shape, 1, spec.n_offsets, spec.radius, itemsize, axpy=True)
    plane = (k1.ty + 2 * spec.radius) * (k1.tz + 2 * 16 // itemsize) * itemsize
    assert ax.smem_bytes == k1.smem_bytes + plane
    assert dataclasses.replace(ax, smem_bytes=k1.smem_bytes) == k1
    assert axpy_staged(shape, itemsize) and not axpy_staged((4, 4, 12), 2)


def _op(shape=SHAPE, policy="bf16_mixed", **kw):
    cf = kw.pop("coeffs", None) or stencil.convection_diffusion(shape, device="cpu")
    return operator.make_operator("fused", cf, policy=precision.get_policy(policy), **kw)


def test_fused_operator_offers_axpy_only_where_q_need_not_exist(monkeypatch):
    """``apply_axpy`` on one rank with the unit diagonal and a Z of whole
    16-B vectors, taking one unbatched block (``takes_axpy``); none with a
    raw diagonal, an odd Z, a split fabric or on another backend."""
    op = _op()
    assert op.apply_axpy is not None
    assert op.takes_axpy(torch.zeros(SHAPE)) and not op.takes_axpy(torch.zeros((2,) + SHAPE))
    assert not dataclasses.replace(op, apply_axpy=None).takes_axpy(torch.zeros(SHAPE))
    assert _op(policy="f32", shape=(6, 7, 12)).apply_axpy is not None   # 12 f32: 3 vectors
    assert _op(shape=(6, 7, 12)).apply_axpy is None                      # 12 bf16: 1.5
    raw = stencil.heterogeneous_poisson(torch.Generator().manual_seed(2), SHAPE)
    assert raw.diag is not None and _op(coeffs=raw).apply_axpy is None
    monkeypatch.setattr(dist, "check_fabric", lambda size: None)    # no process group needed
    assert _op(fabric=FabricAxes(nx=2)).apply_axpy is None
    cf = stencil.convection_diffusion(SHAPE, device="cpu")
    for backend in ("reference", "spmd"):
        assert operator.make_operator(backend, cf).apply_axpy is None


@pytest.mark.parametrize("policy", ["f32", "bf16_mixed"])
@pytest.mark.parametrize("specname", ["star7", "star25"])
def test_fused_solve_same_bits_with_and_without_apply_axpy(specname, policy):
    """The fused BiCGStab loop through ``apply_axpy`` equals the loop that
    forms ``q_in`` first, bit for bit: x, residual, iterations."""
    pol = precision.get_policy(policy)
    cf = stencil.random_nonsymmetric(torch.Generator().manual_seed(5), SHAPE,
                                     spec=stencil.get_spec(specname))
    b = torch.randn(SHAPE, generator=torch.Generator().manual_seed(3)).to(pol.storage)
    op = operator.make_operator("fused", cf, policy=pol)
    assert op.apply_axpy is not None
    kw = dict(tol=1e-4, maxiter=40, policy=pol)
    got = bicgstab_fused_loop(op, b, None, **kw)
    want = bicgstab_fused_loop(dataclasses.replace(op, apply_axpy=None), b, None, **kw)
    assert int(got.iterations) == int(want.iterations) > 2
    assert_bitwise(got.x, want.x)
    assert_bitwise(got.rel_residual, want.rel_residual)


def test_with_apply_clears_apply_axpy():
    """Right preconditioning swaps ``apply`` (``wrap_right``, through
    ``with_apply``): the copy has no ``apply_axpy``, which would skip the
    preconditioner; the preconditioned fused solve equals the same solve on
    an operator that never had one."""
    op = _op(policy="f32")
    assert op.with_apply(op.apply).apply_axpy is None
    M = build_precond(get_precond_config("chebyshev"), op)
    wrapped, _ = wrap_right(op, M)
    assert wrapped.apply_axpy is None and wrapped.fused is op.fused
    b = torch.randn(SHAPE, generator=torch.Generator().manual_seed(4))
    kw = dict(tol=1e-5, maxiter=30, policy=precision.F32)
    bicgstab = get_solver("bicgstab")
    got = bicgstab(op, b, None, precond=M, **kw)
    bare = dataclasses.replace(op, apply_axpy=None)
    want = bicgstab(bare, b, None, precond=build_precond(get_precond_config("chebyshev"), bare),
                    **kw)
    assert int(got.iterations) == int(want.iterations)
    assert_bitwise(got.x, want.x)
