"""BiCGStab's second SpMV with its input unformed: ``A (r - st(alpha) s)``.

The stencil kernel's axpy form (``kernels/stencil_nd/kernel.py:
stencil_nd_axpy``, and ``stencil_nd_batched_axpy`` for a batch of
right-hand sides, one ``alpha`` each) stages ``q = r - st(alpha) s``
itself, and the fused operator offers it as ``apply_axpy`` where ``q`` need
not exist in memory (one rank, the family's unit diagonal, Z a whole number
of 16-B vectors), for one block or a batch.  The CUDA form runs only on the
card (``chip_smoke.py`` holds it bit for bit against K1 and K1b on the
plain ``q_in``); here the wrappers see CPU tensors and take their plain
versions, which the solver's paths must match bit for bit.
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
from repro_torch.kernels.stencil_nd import kernel  # noqa: E402
from repro_torch.kernels.stencil_nd.kernel import (  # noqa: E402
    axpy_staged, launch_plan, stencil_nd_axpy, stencil_nd_batched, stencil_nd_batched_axpy,
)
from repro_torch.kernels.stencil_nd.ref import stencil_nd_ref  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

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
    16-B vectors, taking one block or a batch of them (``takes_axpy``);
    none with a raw diagonal, an odd Z, a split fabric or on another
    backend."""
    op = _op()
    assert op.apply_axpy is not None
    assert op.takes_axpy(torch.zeros(SHAPE)) and op.takes_axpy(torch.zeros((2,) + SHAPE))
    assert not op.takes_axpy(torch.zeros((2, 2) + SHAPE))
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


# ---------------------------------------------------------------------------
# The batched form: one launch for a block of right-hand sides, alpha [B]
# ---------------------------------------------------------------------------

BATCHES = (1, 3, 5)
#: per-RHS alphas, none a bf16 value: each RHS's rounding shows
ALPHAS = (0.6180339, -1.4142135, 0.3183099, 2.7182817, -0.5772157)


@pytest.mark.parametrize("nb", BATCHES)
@pytest.mark.parametrize("storage,accum", [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32")])
@pytest.mark.parametrize("specname", ["star7", "star13", "star25", "box27"])
def test_batched_axpy_plain_version_is_k1b_on_q_in(specname, storage, accum, nb):
    """The batched wrapper's plain version: the plain K1b on ``r -
    alpha.to(dtype)[:, None, None, None] * s``, bit for bit, each RHS with
    its own alpha rounded to storage first; and each slice the unbatched
    axpy form on that slice with that RHS's alpha."""
    spec = stencil.get_spec(specname)
    dt, acc = _T[storage], _T[accum]
    g = torch.Generator().manual_seed(22 + nb)
    r, s = (torch.randn((nb,) + SHAPE, generator=g).to(dt) for _ in range(2))
    cfs = [(0.2 * torch.randn(SHAPE, generator=g)).to(dt) for _ in spec.offsets]
    alpha = torch.tensor(ALPHAS[:nb])
    kw = dict(radius=spec.radius, accum_dtype=acc)
    got = stencil_nd_batched_axpy(alpha, r, s, cfs, spec.offsets, **kw)
    want = stencil_nd_batched(r - alpha.to(dt)[:, None, None, None] * s, cfs, spec.offsets,
                              **kw)
    assert got.dtype == dt and tuple(got.shape) == (nb,) + SHAPE
    assert_bitwise(got, want)
    for b in range(nb):
        assert_bitwise(got[b], stencil_nd_axpy(alpha[b], r[b], s[b], cfs, spec.offsets, **kw))


_BAD = {
    "alpha_0d": lambda r, s: (torch.tensor(1.0), r, s, "alpha of shape"),
    "alpha_short": lambda r, s: (torch.ones(2), r, s, "alpha of shape"),
    "alpha_2d": lambda r, s: (torch.ones(3, 1), r, s, "alpha of shape"),
    "mismatched": lambda r, s: (torch.ones(3), r, s[:, :, :, :8], "one shape and dtype"),
    "mixed_dtype": lambda r, s: (torch.ones(3), r, s.double(), "one shape and dtype"),
    "padded": lambda r, s: (torch.ones(3), torch.zeros((3,) + tuple(n + 2 for n in SHAPE)),
                            torch.zeros((3,) + tuple(n + 2 for n in SHAPE)), "bare"),
    "unbatched": lambda r, s: (torch.ones(1), r[0], s[0], "batch of 3-D blocks"),
    "empty_batch": lambda r, s: (torch.ones(0), r[:0], s[:0], "right-hand sides, got 0"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_batched_axpy_wrapper_refuses(case):
    """alpha not ``[B]``, r and s of another shape or dtype, the padded
    block, an unbatched block and an empty batch are refused."""
    spec = stencil.STAR7
    cfs = [torch.zeros(SHAPE)] * spec.n_offsets
    alpha, r, s, match = _BAD[case](torch.zeros((3,) + SHAPE), torch.zeros((3,) + SHAPE))
    with pytest.raises(ValueError, match=match):
        stencil_nd_batched_axpy(alpha, r, s, cfs, spec.offsets, radius=1)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("nb", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("specname", ["star7", "star13", "star25", "box27"])
def test_batched_axpy_plan_holds_a_plane_of_s_per_rhs(specname, nb, itemsize):
    """The batched axpy form's shared memory is each RHS's ring plus one
    plane of s per RHS of the chunk; its tiles, segments and chunks are
    K1b's, and it fits one block's shared memory."""
    spec = stencil.get_spec(specname)
    shape = (600, 595, 1536)
    k1b = launch_plan(shape, nb, spec.n_offsets, spec.radius, itemsize)
    ax = launch_plan(shape, nb, spec.n_offsets, spec.radius, itemsize, axpy=True)
    plane = (k1b.ty + 2 * spec.radius) * (k1b.tz + 2 * 16 // itemsize) * itemsize
    assert ax.smem_bytes == k1b.smem_bytes + min(k1b.chunk, nb) * plane
    assert dataclasses.replace(ax, smem_bytes=k1b.smem_bytes) == k1b
    assert ax.smem_bytes <= kernel.SMEM_BYTES
    if (specname, nb, itemsize) == ("star7", 3, 2):      # the block cell: 3 x 5 planes
        assert ax.smem_bytes == 77_760


@pytest.mark.parametrize("case,takes", [
    ("batch", True), ("ranks", False), ("raw_diagonal", False), ("odd_z", False),
    ("with_apply", False)])
def test_takes_axpy_for_a_batch(case, takes, monkeypatch):
    """``takes_axpy`` holds for a ``(B, bx, by, Z)`` batch where the
    operator has the form, and not on the fallbacks: a split fabric, a raw
    diagonal, an odd Z, or after ``with_apply`` (right preconditioning)."""
    monkeypatch.setattr(dist, "check_fabric", lambda size: None)
    shape = (6, 7, 12) if case == "odd_z" else SHAPE
    kw = {"ranks": dict(fabric=FabricAxes(nx=2)),
          "raw_diagonal": dict(coeffs=stencil.heterogeneous_poisson(
              torch.Generator().manual_seed(2), SHAPE))}.get(case, {})
    op = _op(shape=shape, **kw)
    if case == "with_apply":
        op = op.with_apply(op.apply)
    assert op.takes_axpy(torch.zeros((3,) + shape)) is takes
    assert op.takes_axpy(torch.zeros(shape)) is takes


def _block_solve(op, b, pol, iters):
    """The fused loop on the block ``b`` under the profiler: the result, the
    ``bicgstab.q_in`` spans and the batched axpy wrapper's calls."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = bicgstab_fused_loop(op, b, None, tol=0.0, maxiter=iters, policy=pol)
    names = [e.name for e in prof.events()]
    return res, names.count("bicgstab.q_in")


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("policy", ["f32", "bf16_mixed"])
@pytest.mark.parametrize("specname", ["star7", "star25", "box27"])
def test_block_solve_same_bits_with_and_without_batched_axpy(specname, policy, nb,
                                                            monkeypatch):
    """A block solve through ``apply_axpy`` (the batched axpy form, once an
    iteration, no ``bicgstab.q_in`` span) equals the same solve forced
    through the plain ``q_in`` route bit for bit: x, per-RHS residuals and
    iteration counts."""
    pol = precision.get_policy(policy)
    cf = stencil.random_nonsymmetric(torch.Generator().manual_seed(5), SHAPE,
                                     spec=stencil.get_spec(specname))
    b = torch.randn((nb,) + SHAPE, generator=torch.Generator().manual_seed(3)).to(pol.storage)
    op = operator.make_operator("fused", cf, policy=pol)
    assert op.takes_axpy(b)
    calls = []
    real = kernel.stencil_nd_batched_axpy

    def counted(alpha, r, s, *a, **kw):
        calls.append((tuple(alpha.shape), tuple(r.shape)))
        return real(alpha, r, s, *a, **kw)

    monkeypatch.setattr(kernel, "stencil_nd_batched_axpy", counted)
    op = operator.make_operator("fused", cf, policy=pol)     # built with the counted form
    iters = 6
    got, got_q_in = _block_solve(op, b, pol, iters)
    assert calls == [((nb,), (nb,) + SHAPE)] * iters and got_q_in == 0
    calls.clear()
    want, want_q_in = _block_solve(dataclasses.replace(op, apply_axpy=None), b, pol, iters)
    assert calls == [] and want_q_in == iters
    assert got.iterations.tolist() == want.iterations.tolist() == [iters] * nb
    assert_bitwise(got.x, want.x)
    assert_bitwise(got.rel_residual, want.rel_residual)
    assert_bitwise(got.breakdown, want.breakdown)
