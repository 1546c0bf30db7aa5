"""The momentum predictor's block solve: three velocity components on one
operator, solved as one ``(3, X, Y, Z)`` block through
``repro_torch.core.bicgstab.solve_distributed`` (the benchmark's
``momentum_star7`` configuration), against the benchmark's segregated
reference (``perfbench/reference/segregated.py``: each component solved on
its own by the plain BiCGStab), and the counters the block's path adds.

Fields are the configuration's convection-diffusion operator (in f32 with a
seeded pointwise perturbation of up to 20%), the right-hand sides ``b_c = A
x_c`` with seeded white-noise ``x_c``; Z is a whole number of 16-B vectors
(16) or not (13).

Tolerances of the comparison with the reference, per component, each with
its largest reading over seeds 0-39 on both meshes (the tests run 0-3):

* f32 (6 iterations, perturbed fields): the two codes differ only in
  summation order (the reference's dots are chunked ``torch.dot``, the
  port's ``policy.dot``; the port's x update is one expression where the
  reference's is two), so x to 1e-4 of its norm (4.0e-5), pointwise to
  1e-3 of its largest magnitude (4.6e-5), true residual within 0.1% of the
  reference's (0.05%);
* bf16_mixed (3 iterations, the configuration's own fields): each vector op
  rounds to bf16 in another order in the two codes, so the iterates part by
  bf16 roundings: x to 3e-2 of its norm (6.5e-3), pointwise 6e-2 (1.4e-2),
  true residual at most 1.5 times the reference's (1.007).  The fp8
  control (the reference with e4m3 storage) reads at least 0.082, 0.125
  and 1.86, so it fails every bound on every seed.

Why 3 bf16 iterations on unperturbed fields: at 16 points an edge bf16's
plateau comes within 4-6 iterations (the cell's 6 are before it at the
paper's mesh), and past it, or on a perturbed operator, some systems take
a near-breakdown in 16-bit storage, where the reference's own bf16 solve
leaves its f32 solve by up to 7.4 of x and the two bf16 codes part by up
to 1.3.  The port's solo solve parts there as much as its block does,
which it equals bit for bit (asserted here at 6 iterations).
"""

import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_port import REPO  # noqa: E402

if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench.metrics.block_iter_roofline import block_iteration_bytes  # noqa: E402
from perfbench.metrics.block_spmv_roofline import block_spmv_bytes  # noqa: E402
from perfbench.metrics.iter_roofline import iteration_bytes  # noqa: E402
from perfbench.metrics.spmv_roofline import spmv_bytes  # noqa: E402
from perfbench.reference import segregated  # noqa: E402
from perfbench.reference import stencil as ref_stencil  # noqa: E402
from perfbench.reference.operators import convection_diffusion  # noqa: E402
from perfbench.reference.precision import PRECISIONS  # noqa: E402
from repro_torch.core import bicgstab  # noqa: E402
from repro_torch.core.precision import get_policy  # noqa: E402
from repro_torch.core.stencil import StencilCoeffs  # noqa: E402
from repro_torch.kernels import _build, reset_launch_counts, rhs_counts  # noqa: E402
from repro_torch.kernels.stencil_nd import kernel, ops  # noqa: E402
from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref, stencil_nd_ref  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

NRHS = 3
SHAPES = [(16, 16, 16), (16, 16, 13)]           # Z a whole number of 16-B vectors, and not
PARAMS = {"peclet": 5.0, "velocity": [1.0, 0.5, 0.25]}     # the configuration's operator
OFFSETS = convection_diffusion.offsets(PARAMS)
#: per precision: (x_gap, x_gap_max, res_ratio) bounds, the iterations solved, and the
#: fields' perturbation
TOL = {"f32": ((1e-4, 1e-3, 1.001), 6, 0.2), "bf16_mixed": ((3e-2, 6e-2, 1.5), 3, 0.0)}
SEEDS = range(4)


@pytest.fixture(autouse=True)
def _fresh_counters():
    reset_launch_counts()
    metrics.reset()
    yield
    reset_launch_counts()
    metrics.reset()


def _fields(shape, seed, perturb):
    """The configuration's fields, each point scaled by 1 + u, u uniform in
    [-perturb, perturb]."""
    gen = torch.Generator().manual_seed(seed)
    base = convection_diffusion.fields(shape, PARAMS, "cpu")
    return {n: f * (1 + perturb * (2 * torch.rand(shape, generator=gen) - 1))
            for n, f in base.items()}


def _system(shape, seed, precision):
    """(f32 fields, the stored block b of NRHS components b_c = A x_c)."""
    fields = _fields(shape, seed, TOL[precision][2])
    prec = PRECISIONS[precision]
    gen = torch.Generator().manual_seed(seed + 1000)
    b = torch.stack([prec.store(ref_stencil.apply_f32(
        fields, OFFSETS, torch.randn(shape, generator=gen))) for _ in range(NRHS)])
    return fields, b


def _port(fields, b, policy, iterations, tol=0.0):
    return bicgstab.solve_distributed(make_mesh_for_devices(), StencilCoeffs(dict(fields)), b,
                                      tol=tol, maxiter=iterations, backend="fused",
                                      policy=get_policy(policy), solver="bicgstab")


def _reference(fields, b, precision, iterations):
    prec = PRECISIONS[precision]
    stored = {n: prec.store(f) for n, f in fields.items()}
    apply_A = lambda v: prec.store(ref_stencil.apply(stored, OFFSETS, v, prec.compute))
    return segregated.solve(apply_A, b, tol=0.0, maxiter=iterations, prec=prec)


def _gaps(fields, b, x, want_x):
    """(x_gap, x_gap_max, res_ratio) of one component against the reference's."""
    def true_res(v):
        r = b.double() - ref_stencil.apply(
            {n: f.double() for n, f in fields.items()}, OFFSETS, v.double(), torch.float64)
        return float(r.norm() / b.double().norm())

    d = x.double() - want_x.double()
    return (float(d.norm() / want_x.double().norm()),
            float(d.abs().max() / want_x.double().abs().max()),
            true_res(x) / true_res(want_x))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("policy", sorted(TOL))
def test_block_matches_segregated_reference(policy, shape, seed):
    """Each component of the block solve is the segregated reference's solve
    of that component, to the precision's tolerance (module docstring)."""
    bounds, iterations, _ = TOL[policy]
    fields, b = _system(shape, seed, policy)
    res = _port(fields, b, policy, iterations)
    assert tuple(res.x.shape) == (NRHS,) + shape
    assert res.iterations.tolist() == [iterations] * NRHS
    assert not bool(res.breakdown.any())
    want = _reference(fields, b, policy, iterations)
    assert [w.iterations for w in want] == [iterations] * NRHS
    for c in range(NRHS):
        gaps = _gaps(fields, b[c], res.x[c], want[c].x)
        assert all(g <= lim for g, lim in zip(gaps, bounds)), (c, gaps, bounds)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fp8_control_fails_the_bf16_tolerances(shape):
    """The segregated reference with fp8 storage, put in the program's place,
    fails a bf16 bound in some component on every seed: the bounds can tell
    a wrong precision."""
    bounds, iterations, _ = TOL["bf16_mixed"]
    for seed in SEEDS:
        fields, b = _system(shape, seed, "bf16_mixed")
        want = _reference(fields, b, "bf16_mixed", iterations)
        ctl = _reference(fields, b, "fp8_mixed", iterations)
        assert any(g > lim for c in range(NRHS)
                   for g, lim in zip(_gaps(fields, b[c], ctl[c].x, want[c].x), bounds))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_block_is_three_solo_solves_bit_for_bit(shape):
    """At the cell's 6 iterations each component of the block is the port's
    own solve of that component alone, bit for bit: per-RHS scalars and
    kernels whose every RHS slice is the one-RHS arithmetic."""
    fields, b = _system(shape, 5, "bf16_mixed")
    res = _port(fields, b, "bf16_mixed", 6)
    for c in range(NRHS):
        solo = _port(fields, b[c], "bf16_mixed", 6)
        assert torch.equal(res.x[c], solo.x)
        assert int(res.iterations[c]) == int(solo.iterations)
        assert torch.equal(res.rel_residual[c], solo.rel_residual)


def _q_in_spans(fn):
    """``fn()`` under the profiler: its result and the ``bicgstab.q_in``
    spans it opened."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    return res, sum(e.name == "bicgstab.q_in" for e in prof.events())


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("policy", sorted(TOL))
def test_block_through_batched_axpy_is_the_q_in_route_bit_for_bit(policy, seed, monkeypatch):
    """The cell's block solve takes the batched axpy form for its second
    SpMV and opens no ``bicgstab.q_in`` span; the same solve forced through
    the plain ``q_in`` route (the operator built without the form) gives x,
    the per-RHS residuals and iteration counts bit for bit."""
    fields, b = _system(SHAPES[0], seed, policy)
    iterations = TOL[policy][1]
    got, got_q_in = _q_in_spans(lambda: _port(fields, b, policy, iterations))
    monkeypatch.setattr(kernel, "axpy_staged", lambda shape, itemsize: False)
    want, want_q_in = _q_in_spans(lambda: _port(fields, b, policy, iterations))
    assert (got_q_in, want_q_in) == (0, iterations)
    assert got.iterations.tolist() == want.iterations.tolist() == [iterations] * NRHS
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.rel_residual, want.rel_residual)
    assert torch.equal(got.breakdown, want.breakdown)


# ---------------------------------------------------------------------------
# The counters: right-hand sides a batched SpMV launch, per-RHS freeze merges
# ---------------------------------------------------------------------------

class _StandIn:
    """Stands in for the kernel library: ``repro_stencil_nd`` and
    ``repro_stencil_nd_axpy`` write the plain version's result into the
    output the wrapper allocated, and record the right-hand sides each was
    handed."""

    def __init__(self, outputs):
        self.outputs, self.pending, self.nbs, self.axpy_nbs = outputs, None, [], []

    def repro_stencil_nd(self, dtype, accum, vp_ptr, bare, ptrs, offs, n_off, r, nb, bx, by,
                         bz, u_ptr, ty, tz, seg_len, chunk, stream):
        vp, coeffs, offsets, accum_dtype = self.pending
        assert vp.data_ptr() == vp_ptr and nb == vp.shape[0] and chunk >= 1
        u = (stencil_nd_ref(vp, coeffs, offsets, accum_dtype=accum_dtype) if bare else
             stencil_nd_padded_ref(vp, coeffs, offsets, radius=r, accum_dtype=accum_dtype))
        self.outputs[u_ptr].copy_(u)
        self.nbs.append(nb)
        return 0

    def repro_stencil_nd_axpy(self, dtype, accum, r_ptr, s_ptr, alpha_ptr, ptrs, offs, n_off,
                              radius, nb, bx, by, bz, u_ptr, ty, tz, seg_len, chunk, stream):
        alpha, r, s, coeffs, offsets, accum_dtype = self.pending
        assert (r.data_ptr(), s.data_ptr(), alpha.data_ptr()) == (r_ptr, s_ptr, alpha_ptr)
        assert nb == r.shape[0] == alpha.numel() and chunk >= 1
        q = r - alpha.to(r.dtype).reshape((nb, 1, 1, 1)) * s
        self.outputs[u_ptr].copy_(stencil_nd_ref(q, coeffs, offsets, accum_dtype=accum_dtype))
        self.axpy_nbs.append(nb)
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """The batched SpMVs of a CPU solve (K1b and its axpy form) sent through
    the wrappers' launch paths (check bypassed for the device, a stand-in
    library) instead of the plain versions; the launch counters are this
    test's own."""
    outputs = {}
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        outputs[t.data_ptr()] = t
        return t

    lib = _StandIn(outputs)

    def batched(vp, coeffs, offsets, *, radius, accum_dtype=torch.float32):
        lib.pending = (vp, coeffs, offsets, accum_dtype)
        return kernel._launch("stencil_nd_batched", vp, coeffs, offsets, radius, accum_dtype,
                              True)

    def batched_axpy(alpha, r, s, coeffs, offsets, *, radius, accum_dtype=torch.float32):
        lib.pending = (alpha, r, s, coeffs, offsets, accum_dtype)
        return kernel._launch_axpy("stencil_nd_batched_axpy", alpha, r, s, coeffs, offsets,
                                   radius, accum_dtype, True)

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(kernel, "_check", lambda what, vp, coeffs, offsets, r, nb:
                        kernel._form(what, vp, coeffs, r, nb))
    monkeypatch.setattr(kernel, "launches", dict.fromkeys(kernel.launches, 0))
    monkeypatch.setattr(kernel, "rhs", dict.fromkeys(kernel.rhs, 0))
    monkeypatch.setattr(ops, "stencil_nd_batched", batched)
    monkeypatch.setattr(kernel, "stencil_nd_batched_axpy", batched_axpy)
    return lib


def test_each_batched_spmv_launch_serves_the_block(stand_in):
    """A B = 3 solve launches the batched stencil once an iteration (the
    first SpMV) and its axpy form once (the second, forming r - st(alpha) s
    itself), each launch serving all 3 right-hand sides, and gives the plain
    solve's bits."""
    fields, b = _system(SHAPES[0], 6, "bf16_mixed")
    res = _port(fields, b, "bf16_mixed", 6)
    assert stand_in.nbs == [NRHS] * 6 and stand_in.axpy_nbs == [NRHS] * 6
    assert kernel.launches["stencil_nd_batched"] == kernel.launches["stencil_nd_batched_axpy"] == 6
    assert rhs_counts() == {"stencil_nd_batched": 6 * NRHS, "stencil_nd_batched_axpy": 6 * NRHS}
    assert kernel.launches["stencil_nd"] == kernel.launches["stencil_nd_axpy"] == 0
    reset_launch_counts()
    assert rhs_counts() == {"stencil_nd_batched": 0, "stencil_nd_batched_axpy": 0}
    assert kernel.launches["stencil_nd_batched"] == kernel.launches["stencil_nd_batched_axpy"] == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "stencil_nd_batched", kernel.stencil_nd_batched)
        want = _port(fields, b, "bf16_mixed", 6)
    assert torch.equal(res.x, want.x)


def test_the_plain_version_counts_no_rhs():
    """CPU tensors take the plain version: no launch, no right-hand side
    counted."""
    fields, b = _system(SHAPES[1], 7, "f32")
    _port(fields, b, "f32", 2)
    assert rhs_counts() == {"stencil_nd_batched": 0, "stencil_nd_batched_axpy": 0}


def _merges() -> int:
    return metrics.snapshot()["counters"].get("krylov.freeze_merges")


def test_no_freeze_merge_while_every_rhs_runs_to_maxiter():
    fields, b = _system(SHAPES[0], 8, "bf16_mixed")
    res = _port(fields, b, "bf16_mixed", 5)
    assert res.iterations.tolist() == [5] * NRHS
    assert _merges() == 0


def test_freeze_merges_count_the_iterations_after_an_rhs_stops():
    """A zero component has converged before the first step: every
    iteration of the block then merges the step's result per RHS."""
    fields, b = _system(SHAPES[0], 9, "bf16_mixed")
    b[1] = 0
    res = _port(fields, b, "bf16_mixed", 4, tol=1e-6)
    assert res.iterations.tolist() == [4, 0, 4]
    assert _merges() == 4
    metrics.reset()
    assert _merges() is None


def test_freeze_merges_count_an_rhs_converging_early():
    """One component converges at a looser tolerance than the others reach:
    the iterations after its exit merge."""
    fields, b = _system(SHAPES[0], 10, "f32")
    full = _port(fields, b, "f32", 30, tol=1e-3)
    its = full.iterations.tolist()
    assert min(its) < max(its), its
    assert _merges() == max(its) - min(its)


def test_bundle_carries_both_counters(tmp_path):
    """The ``--obs`` bundle of a 3-RHS solve carries the batched stencil's
    and its axpy form's launches and right-hand sides (0 on CPU tensors)
    and the freeze merges."""
    from repro_torch.launch import solve

    out = solve.main(["--device", "cpu", "--backend", "fused", "--mesh", "6", "6", "8",
                      "--policy", "f32", "--nrhs", "3", "--run-dir",
                      str(tmp_path / "run")])
    from repro_torch.obs import manifest

    man = manifest.load_manifest(out["run_dir"])
    gauges = man["metrics"]["gauges"]
    for name in ("stencil_nd_batched", "stencil_nd_batched_axpy"):
        assert gauges[f"kernels.{name}.rhs"] == gauges[f"kernels.{name}.launches"] == 0
    assert man["metrics"]["counters"]["krylov.freeze_merges"] >= 0


# ---------------------------------------------------------------------------
# The block metrics' byte counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("points,n_fields,itemsize", [(548_352_000, 6, 2), (1000, 26, 4),
                                                      (729, 12, 2)])
def test_block_byte_counts_at_one_rhs_are_the_one_rhs_counts(points, n_fields, itemsize):
    assert block_spmv_bytes(points, n_fields, itemsize, 1) == spmv_bytes(points, n_fields,
                                                                         itemsize)
    assert (block_iteration_bytes("bicgstab", points, n_fields, itemsize, 1)
            == iteration_bytes("bicgstab", points, n_fields, itemsize))


def test_block_byte_counts_at_the_cell():
    """At B = 3 on the paper's mesh, star7 bf16: an SpMV moves F + 2B = 12
    words a point, an iteration 2F + 17B = 63."""
    points = 600 * 595 * 1536
    assert block_spmv_bytes(points, 6, 2, 3) == 12 * points * 2
    assert block_iteration_bytes("bicgstab", points, 6, 2, 3) == 63 * points * 2
