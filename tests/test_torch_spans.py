"""The port's spans on the solve path: off, they are one shared no-op that
opens no profiler range; live (tracing on, or ``torch.profiler``
recording), they nest as the solve runs, carry ids, and leave the solve's
bits unchanged."""

import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one intra-op thread)
from torch.autograd import profiler as torch_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import bicgstab, comm  # noqa: E402
from repro_torch.core.halo import FabricAxes  # noqa: E402
from repro_torch.core.precision import get_policy  # noqa: E402
from repro_torch.core.stencil import convection_diffusion, heterogeneous_poisson  # noqa: E402
from repro_torch.kernels.stencil_nd import kernel as stencil_kernel  # noqa: E402
from repro_torch.kernels.stencil_nd import ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402

SHAPE = (12, 10, 8)
ITERS = 4
SOLVE_SPANS = {"solve.cast_fields", "operator.build", "krylov.init", "krylov.iteration"}


@pytest.fixture(autouse=True)
def _clean():
    metrics.reset()
    trace.reset()
    trace.disable()
    yield
    metrics.reset()
    trace.reset()
    trace.disable()


def _solve(nrhs: int = 1, **kw):
    cf = convection_diffusion(SHAPE, device="cpu")
    gen = torch.Generator().manual_seed(7)
    b = torch.randn(((nrhs,) if nrhs > 1 else ()) + SHAPE, generator=gen)
    kw = dict(dict(tol=0.0, maxiter=ITERS), **kw)
    return bicgstab.solve_distributed(make_mesh_for_devices(), cf, b.to(torch.bfloat16),
                                      policy=get_policy("bf16_mixed"), backend="fused", **kw)


def _profiled(**kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _solve(**kw)
    return res, [e for e in prof.events() if not e.name.startswith(("aten::", "detach"))]


def _parent(e) -> str | None:
    return e.cpu_parent.name if e.cpu_parent is not None else None


def _stub_axpy(monkeypatch):
    """Record K1's axpy form (the second SpMV, its input formed as it is
    staged), unbatched and batched, as a profiler range ``k1_axpy`` around
    the real wrapper."""
    for name in ("stencil_nd_axpy", "stencil_nd_batched_axpy"):
        def k1_axpy(alpha, r, s, *a, real=getattr(stencil_kernel, name), **kw):
            with torch_profiler.record_function("k1_axpy"):
                return real(alpha, r, s, *a, **kw)

        monkeypatch.setattr(stencil_kernel, name, k1_axpy)


def test_off_span_is_the_shared_noop_and_opens_no_range(monkeypatch):
    entered = []
    real = torch_profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch_profiler, "record_function", counting)
    assert not torch_profiler._is_profiler_enabled and not trace.is_enabled()
    assert trace.span("a") is trace.span("b", k=1) is trace._NULL
    _solve()
    assert entered == [] and trace.events() == []
    trace.enable()                       # the port's tracing alone records, opens no range
    _solve()
    assert entered == [] and {e["name"] for e in trace.events()} >= SOLVE_SPANS


def test_profiler_records_the_solve_tree(monkeypatch):
    _stub_axpy(monkeypatch)
    res, evs = _profiled()
    assert int(res.iterations) == ITERS and not trace.is_enabled()
    by = {}
    for e in evs:
        by.setdefault(e.name, []).append(e)
    assert len(by["solve"]) == 1 and _parent(by["solve"][0]) is None
    for name in SOLVE_SPANS:
        assert {_parent(e) for e in by[name]} == {"solve"}, name
    assert "tuning.lookup" not in by        # K1's plan is its own: nothing is looked up
    assert len(by["krylov.iteration"]) == ITERS
    # one flag read before the first step and after each step but the last
    assert len(by["krylov.flag_wait"]) == ITERS
    assert {_parent(e) for e in by["krylov.flag_wait"]} == {"krylov.iteration"}
    # one rank: the second SpMV forms q itself, once an iteration, and no
    # bicgstab.q_in opens (test_q_in_span_on_the_fallback_paths keeps it)
    assert "bicgstab.q_in" not in by
    assert len(by["k1_axpy"]) == ITERS
    assert {_parent(e) for e in by["k1_axpy"]} == {"krylov.iteration"}
    # the program's events are the profiler's ranges
    names = [e["name"] for e in trace.events()]
    assert sorted(names) == sorted(e.name for e in evs if e.name in set(names))


def test_pad_twice_an_iteration(monkeypatch):
    """One rank: K1 stages the SpMV's zero halo itself, so no ``stencil.pad``
    span opens; K1 runs on the bare iterate once an iteration under
    ``comm.halo.interior``, and its axpy form, which also forms its input
    ``r - st(alpha) s``, once an iteration under ``krylov.iteration``."""
    _stub_axpy(monkeypatch)
    real = ops.stencil_nd

    def k1(block, *a, **kw):
        with torch_profiler.record_function("k1"):
            assert tuple(block.shape) == SHAPE
            return real(block, *a, **kw)

    monkeypatch.setattr(ops, "stencil_nd", k1)
    _, evs = _profiled()
    assert not [e for e in evs if e.name == "stencil.pad"]
    k1s = [e for e in evs if e.name == "k1"]
    assert len(k1s) == ITERS
    assert {_parent(e) for e in k1s} == {"comm.halo.interior"}
    axpys = [e for e in evs if e.name == "k1_axpy"]
    assert len(axpys) == ITERS
    assert {_parent(e) for e in axpys} == {"krylov.iteration"}


def test_a_block_forms_q_in_its_spmv(monkeypatch):
    """One rank, a batch of right-hand sides with Z a whole number of 16-B
    vectors: the second SpMV is the batched axpy form, once an iteration
    under ``krylov.iteration``, and no ``bicgstab.q_in`` opens."""
    _stub_axpy(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _solve(3)
    assert res.iterations.tolist() == [ITERS] * 3
    assert not [e for e in prof.events() if e.name == "bicgstab.q_in"]
    axpys = [e for e in prof.events() if e.name == "k1_axpy"]
    assert len(axpys) == ITERS
    assert {_parent(e) for e in axpys} == {"krylov.iteration"}


@pytest.mark.parametrize("case", ["batched", "odd_z", "raw_diagonal"])
def test_q_in_span_on_the_fallback_paths(case, monkeypatch):
    """Where the operator has no axpy form for the operands (a Z that is no
    whole number of 16-B vectors, for a batch of right-hand sides or one; a
    raw diagonal), the step forms ``q_in`` by plain ops, once an iteration
    under ``bicgstab.q_in``, and neither wrapper of the axpy form runs."""
    _stub_axpy(monkeypatch)
    shape, nrhs = {"batched": ((12, 10, 9), 2), "odd_z": ((12, 10, 9), 1),
                   "raw_diagonal": (SHAPE, 1)}[case]
    gen = torch.Generator().manual_seed(7)
    cf = (heterogeneous_poisson(gen, shape) if case == "raw_diagonal"
          else convection_diffusion(shape, device="cpu"))
    b = torch.randn(((nrhs,) if nrhs > 1 else ()) + shape, generator=gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = bicgstab.solve_distributed(make_mesh_for_devices(), cf, b.to(torch.bfloat16),
                                         policy=get_policy("bf16_mixed"), backend="fused",
                                         tol=0.0, maxiter=ITERS)
    assert int(res.iterations.max()) == ITERS
    q_in = [e for e in prof.events() if e.name == "bicgstab.q_in"]
    assert len(q_in) == ITERS
    assert {_parent(e) for e in q_in} == {"krylov.iteration"}
    assert not [e for e in prof.events() if e.name == "k1_axpy"]


@pytest.mark.parametrize("nrhs", [1, 2])
def test_one_iteration_span_per_step_when_the_flag_stops_the_loop(nrhs):
    trace.enable()
    res = _solve(nrhs, tol=1e-2, maxiter=60)
    its = res.iterations.max() if nrhs > 1 else res.iterations
    assert 0 < int(its) < 60
    names = [e["name"] for e in trace.events()]
    assert names.count("krylov.iteration") == int(its)
    assert names.count("krylov.flag_wait") == int(its) + 1    # the last read stops it


def test_events_carry_ids_and_self_time():
    trace.enable()
    with trace.span("outside"):
        pass
    with trace.span("solve"):
        with trace.span("a"):
            with trace.span("b"):
                pass
            with trace.span("c"):
                pass
    ev = {e["name"]: e for e in trace.events()}
    solve, a = ev["solve"], ev["a"]
    assert ev["outside"]["solve_id"] is None and ev["outside"]["parent_id"] is None
    assert {e["solve_id"] for n, e in ev.items() if n != "outside"} == {solve["id"]}
    assert (a["parent_id"], ev["b"]["parent_id"], ev["c"]["parent_id"]) == (
        solve["id"], a["id"], a["id"])
    assert ev["b"]["parent"] == "a" and ev["b"]["depth"] == 2
    own = trace.self_us(trace.events())
    assert own[a["id"]] == pytest.approx(a["dur_us"] - ev["b"]["dur_us"] - ev["c"]["dur_us"])
    assert own[solve["id"]] == pytest.approx(solve["dur_us"] - a["dur_us"])
    only_b = trace.self_us(trace.events(), ("b",))
    assert only_b[a["id"]] == pytest.approx(a["dur_us"] - ev["b"]["dur_us"])
    assert only_b[solve["id"]] == solve["dur_us"]


def test_every_span_of_a_solve_shares_its_id():
    trace.enable()
    _solve()
    _solve()
    solves = [e["id"] for e in trace.events() if e["name"] == "solve"]
    assert len(solves) == 2
    assert {e["solve_id"] for e in trace.events()} == set(solves)


@pytest.mark.parametrize("nrhs,tol", [(1, 0.0), (1, 1e-2), (2, 1e-2)])
@pytest.mark.parametrize("live", ["profiler", "tracing"])
def test_solve_bits_the_same_with_spans_live_and_off(nrhs, tol, live):
    off = _solve(nrhs, tol=tol, maxiter=40)
    if live == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            on = _solve(nrhs, tol=tol, maxiter=40)
    else:
        trace.enable()
        on = _solve(nrhs, tol=tol, maxiter=40)
    assert trace.events()
    for f in ("x", "iterations", "rel_residual", "converged", "breakdown"):
        assert torch.equal(getattr(off, f), getattr(on, f)), f


class _StubPost:
    """Stands in for a posted exchange on a split fabric: the zero pad."""

    def __init__(self, v, fabric, radius, *, corners, n_batch):
        self.v, self.r = v, radius

    def wait(self):
        return torch.nn.functional.pad(self.v, (self.r, self.r) * 3)


@pytest.mark.parametrize("split", [False, True])
def test_issue_and_ring_spans_only_on_a_split_fabric(split, monkeypatch):
    monkeypatch.setattr(comm, "HaloPost", _StubPost)
    cf = convection_diffusion((8, 8, 6), device="cpu")
    v = torch.randn((8, 8, 6), generator=torch.Generator().manual_seed(3))
    fabric = FabricAxes(nx=2) if split else FabricAxes()
    trace.enable()
    comm.scheduled_apply(cf, v, fabric, schedule="overlap")
    names = {e["name"] for e in trace.events()}
    assert "comm.halo.interior" in names
    assert {"comm.halo.issue", "comm.halo.ring"} <= names if split else not (
        {"comm.halo.issue", "comm.halo.ring"} & names)
    assert metrics.counter("comm.halo_exchanges").value == 1


def test_span_list_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "MAX_EVENTS", 3)
    trace.enable()
    for i in range(5):
        with trace.span("s", i=i):
            pass
    assert [e["attrs"]["i"] for e in trace.events()] == [0, 1, 2]
    assert metrics.counter("trace.dropped").value == 2
