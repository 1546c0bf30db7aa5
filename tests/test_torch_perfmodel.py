"""The port's op counts (``core/stencil.py``, ``configs/stencil_cs1.py``) and
performance model (``core/perfmodel.py``) against the JAX package's.

The counts are integers and must be equal.  The model's three terms must
equal the reference's to 1e-12 relative once the reference's constants are
patched into the port; the port's own constants are the H100 table."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import stencil_cs1 as jax_cells  # noqa: E402
from repro.core import perfmodel as jax_model  # noqa: E402
from repro.core import stencil as jax_stencil  # noqa: E402
from repro_torch.configs import stencil_cs1  # noqa: E402
from repro_torch.core import perfmodel, stencil  # noqa: E402

SPECS = ["star7", "star13", "star25", "box27"]


def test_offsets_and_point_counts():
    assert stencil.OFFSETS == jax_stencil.OFFSETS
    for ndim in (2, 3):
        assert stencil.flops_per_point(ndim) == jax_stencil.flops_per_point(ndim)
        assert stencil.words_per_point(ndim) == jax_stencil.words_per_point(ndim)
    assert stencil_cs1.ops_per_meshpoint() == jax_cells.ops_per_meshpoint()
    assert stencil_cs1.ops_per_meshpoint()["total"] == perfmodel.FLOPS_PER_PT


@pytest.mark.parametrize("name", SPECS)
def test_spec_counts_equal_reference(name):
    spec, ref = stencil.get_spec(name), jax_stencil.get_spec(name)
    assert stencil.spec_flops_per_point(spec) == jax_stencil.spec_flops_per_point(ref)
    assert stencil.spec_words_per_point(spec) == jax_stencil.spec_words_per_point(ref)
    for block in [(8, 8, 8), (608, 608, 1536), (37, 29, 17), (4, 6, 5)]:
        for axes in [(0,), (1,), (0, 1), (0, 1, 2), (2, 0)]:
            assert (stencil.halo_words_per_spmv(spec, block, axes)
                    == jax_stencil.halo_words_per_spmv(ref, block, axes)), (block, axes)


def test_h100_constants():
    """The data sheet's H100 SXM figures; none of the TPU's survives."""
    assert (perfmodel.HBM_BW, perfmodel.PEAK_FLOPS, perfmodel.LINK_BW) == (3.35e12, 67e12,
                                                                          450e9)
    tpu = {jax_model.PEAK_FLOPS, jax_model.HBM_BW, jax_model.LINK_BW}
    assert not tpu & {perfmodel.HBM_BW, perfmodel.PEAK_FLOPS, perfmodel.LINK_BW}
    assert not hasattr(perfmodel, "HOP_LATENCY_S")
    assert {k: dataclasses.astuple(v) for k, v in perfmodel.SOLVER_COMMS.items()} == {
        k: dataclasses.astuple(v) for k, v in jax_model.SOLVER_COMMS.items()}


def test_allreduce_latency_needs_a_measured_hop_beyond_one_chip():
    assert perfmodel.allreduce_latency(1, 1) == 0.0
    with pytest.raises(ValueError, match="hop_latency_s"):
        perfmodel.allreduce_latency(2, 2)
    with pytest.raises(ValueError, match="hop_latency_s"):
        perfmodel.iteration_time_model((608, 608, 1536), 4)
    assert perfmodel.allreduce_latency(4, 4, hop_latency_s=2e-6) == 2 * 4 * 2e-6


@pytest.fixture
def reference_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(perfmodel, name, getattr(jax_model, name))
    return {"hop_latency_s": jax_model.HOP_LATENCY_S}


def _close(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float):
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=0.0), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("solver", sorted(jax_model.SOLVER_COMMS))
@pytest.mark.parametrize("schedule", ["blocking", "overlap"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "separate"])
def test_iteration_model_equals_reference(reference_constants, solver, schedule, fused):
    for mesh, chips, pods in [((608, 608, 1536), 1, 1), ((608, 608, 1536), 4, 1),
                              ((600, 595, 1536), 256, 1), ((608, 608, 608), 16, 4)]:
        for sweeps in (False, True):
            kw = dict(itemsize=2, fused_reductions=fused, fused_sweeps=sweeps, solver=solver,
                      schedule=schedule, pods=pods)
            _close(perfmodel.iteration_time_model(mesh, chips, **kw, **reference_constants),
                   jax_model.iteration_time_model(mesh, chips, **kw))


def test_crossover_and_mfix_equal_reference(reference_constants):
    mesh = (608, 608, 1536)
    base, alt = {"solver": "bicgstab"}, {"solver": "pipelined_bicgstab"}
    got = perfmodel.predict_crossover(mesh, base, alt, **reference_constants)
    want = jax_model.predict_crossover(mesh, base, alt)
    assert got["crossover_chips"] == want["crossover_chips"]
    for g, w in zip(got["rows"], want["rows"]):
        _close(g, w)
    assert perfmodel.mfix_timesteps_per_second(mesh, 16, **reference_constants) == (
        pytest.approx(jax_model.mfix_timesteps_per_second(mesh, 16), rel=1e-12))


def test_one_chip_model_on_the_h100():
    """One card: no reduction latency, no halo; star7 BiCGStab at the paper
    mesh is bound by device memory (42 bf16 words a point at 3.35 TB/s)."""
    m = perfmodel.iteration_time_model((608, 608, 1536), 1)
    assert m["t_reduce_s"] == 0.0 and m["bound"] == "memory"
    assert m["t_memory_s"] == pytest.approx(42 * 2 * 608 * 608 * 1536 / 3.35e12, rel=1e-12)
