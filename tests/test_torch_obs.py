"""The port's observability layer (``repro_torch/obs``) against the JAX
package's (``repro/obs``): spans, the metrics registry, and run bundles in
the shared ``repro.obs.v1`` schema.

The same calls must give the same snapshot and the same events in both
registries; a port bundle must pass both packages' schema checks and be
read by ``scripts/compare_runs.py`` unchanged."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import REPO  # noqa: E402
from repro.obs import manifest as jax_manifest  # noqa: E402
from repro.obs import metrics as jax_metrics  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro_torch.obs import manifest, metrics, trace  # noqa: E402


@pytest.fixture(autouse=True)
def _port_obs_reset():
    """The port's registries are process-global too; keep tests isolated."""
    metrics.reset()
    trace.reset()
    yield
    metrics.reset()
    trace.reset()
    trace.disable()


# ---------------------------------------------------------------- spans --

def test_disabled_span_is_one_shared_noop():
    trace.disable()
    s1, s2 = trace.span("a"), trace.span("b", k=1)
    assert s1 is s2
    with s1 as sp:
        x = torch.ones(3)
        assert sp.block(x) is x
        sp.set(x=1)
    assert trace.events() == []


def _drive(tr):
    tr.enable()
    with tr.span("outer", tag="t"):
        with tr.span("inner", k=2) as sp:
            sp.set(result="ok")


def test_spans_nest_and_export_like_the_reference():
    _drive(trace)
    _drive(jax_trace)
    try:
        got, want = trace.events(), jax_trace.events()
        assert [e["name"] for e in got] == [e["name"] for e in want] == ["inner", "outer"]
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            assert (g["depth"], g["parent"], g.get("attrs")) == (
                w["depth"], w["parent"], w.get("attrs"))
        doc, ref = trace.chrome_trace(), jax_trace.chrome_trace()
        assert doc.keys() == ref.keys() and doc["displayTimeUnit"] == ref["displayTimeUnit"]
        for g, w in zip(doc["traceEvents"], ref["traceEvents"]):
            assert g.keys() == w.keys() and g["args"] == w["args"] and g["ph"] == "X"
        json.dumps(doc)
    finally:
        jax_trace.reset()
        jax_trace.disable()


def test_block_does_not_synchronise_a_cpu_tensor(monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("a CPU tensor needs no synchronise")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    trace.enable(sync=True)
    with trace.span("s", sync=True) as sp:
        x = torch.full((3,), 2.0)
        assert sp.block(x) is x
    assert trace.events()[-1]["name"] == "s"


# -------------------------------------------------------------- metrics --

def _calls(m):
    m.counter("c").inc()
    m.counter("c").inc(2)
    m.gauge("g").set(3.5)
    for v in (1.0, 2.0, 3.0):
        m.histogram("h").observe(v)
    m.event("e1", a=1)
    m.event("e2", kind="payload-field")
    m.roofline_fraction(1.5e12, peak_flops_per_s=6e12)


def _strip(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_same_calls_same_snapshot():
    _calls(metrics)
    _calls(jax_metrics)
    assert metrics.snapshot() == jax_metrics.snapshot()
    assert _strip(metrics.events()) == _strip(jax_metrics.events())


def test_roofline_defaults_to_the_h100_f32_peak():
    assert metrics.roofline_fraction(6.7e12) == pytest.approx(0.1, rel=1e-12)


class _Result:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("nrhs", [1, 3])
def test_record_solve_event_equals_reference(nrhs):
    rng = np.random.default_rng(7)
    shape = () if nrhs == 1 else (nrhs,)
    fields = dict(iterations=rng.integers(3, 9, size=shape).astype(np.int32),
                  converged=rng.random(shape) < 0.5,
                  rel_residual=rng.random(shape).astype(np.float32),
                  breakdown=rng.random(shape) < 0.2,
                  history=rng.random((12,) + shape).astype(np.float32))
    port = _Result(**{k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()})
    ref = _Result(**{k: np.asarray(v) for k, v in fields.items()})
    got = metrics.record_solve(port, wall_s=0.25, solver="bicgstab", nrhs=nrhs)
    want = jax_metrics.record_solve(ref, wall_s=0.25, solver="bicgstab", nrhs=nrhs)
    assert _strip([got]) == _strip([want])
    assert metrics.snapshot() == jax_metrics.snapshot()


def test_record_collectives_matches_the_reference_event():
    """The port takes executed counts; the reference counts ops in HLO
    text.  The same totals give the same gauges and event."""
    text = "all-reduce " * 4 + "collective-permute " * 2
    want = jax_metrics.record_collectives(text, solver="bicgstab", schedule="overlap")
    got = metrics.record_collectives(want, solver="bicgstab", schedule="overlap")
    assert got == want == {"allreduce_total": 4, "ppermute_total": 2}
    assert metrics.snapshot() == jax_metrics.snapshot()
    assert _strip(metrics.events()) == _strip(jax_metrics.events())


# ------------------------------------------------------------- manifest --

def _cli_bundle(run_dir, *extra):
    from repro_torch.launch import solve

    return solve.main(["--device", "cpu", "--backend", "fused", "--mesh", "6", "6", "6",
                       "--policy", "f32", "--run-dir", str(run_dir), *extra])


def test_bundle_passes_both_schema_checks(tmp_path):
    out = _cli_bundle(tmp_path / "run")
    assert out["run_dir"] == str(tmp_path / "run")
    man = manifest.load_manifest(out["run_dir"])
    assert manifest.validate_manifest(man) == []
    assert jax_manifest.validate_manifest(man) == []
    assert man["devices"]["platform"] in ("cpu", "gpu")
    assert {"torch", "cuda", "numpy"} <= set(man["versions"])
    gauges = man["metrics"]["gauges"]
    assert gauges["solve.iterations_max"] == out["iterations"]
    # the kernels' launch counts ride the bundle (0 on CPU tensors)
    assert gauges["kernels.stencil_nd.launches"] == 0
    assert "kernels.stencil7_dot.launches" in gauges


def _compare(base, cand):
    return subprocess.run([sys.executable, os.path.join(REPO, "scripts", "compare_runs.py"),
                           str(base), str(cand)], capture_output=True, text=True, timeout=60)


def test_compare_runs_reads_port_bundles(tmp_path):
    base = tmp_path / "base"
    _cli_bundle(base)
    cand = tmp_path / "cand"
    shutil.copytree(base, cand)
    out = _compare(base, cand)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "collectives.allreduce_total" in out.stdout
    man = json.loads((cand / "manifest.json").read_text())
    man["metrics"]["gauges"]["solve.iterations_max"] += 1
    (cand / "manifest.json").write_text(json.dumps(man))
    out = _compare(base, cand)
    assert out.returncode == 1 and "solve.iterations_max" in out.stderr


def test_profiler_that_cannot_start_fails_the_run(tmp_path, monkeypatch):
    import torch.profiler

    def broken(*a, **k):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        manifest.start_run("solve", run_dir=str(tmp_path / "r"), profile=True)


def test_cuda_profile_without_device_activity_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(trace, "device_time_us", lambda prof: 0.0)
    prof = trace.Profile(str(tmp_path), cuda=False)
    prof.cuda = True            # as on the card, where the profile asked for CUDA activity
    with pytest.raises(RuntimeError, match="no CUDA device activity"):
        prof.stop()
    assert os.path.exists(prof.trace_path)


def test_profile_writes_a_trace_on_the_cpu(tmp_path):
    with trace.profile(str(tmp_path / "p"), cuda=False) as prof:
        torch.ones(64).sum()
    doc = json.loads(open(prof.trace_path).read())
    assert doc["traceEvents"]


def test_benchmark_bundle(tmp_path):
    run_dir = manifest.write_benchmark_bundle("demo", {"schema": "x", "generated_by": "t"},
                                              root=str(tmp_path))
    man = manifest.load_manifest(run_dir)
    assert man["benchmark"] == "demo" and manifest.validate_manifest(man) == []
    assert json.loads(open(os.path.join(run_dir, "record.json")).read())["schema"] == "x"
