"""The port's tuning cache (``core/tuning.py``) and the boundary-ring fold
(``kernels/stencil_nd/fused.py:fused_ring_apply``), mirroring the JAX
package's ``tests/test_tuning.py`` where it applies.

The contract is the reference's: with no valid entry the kernel runs its
default plan (exactly the launch plan it had before the cache), and any
valid config gives the same bits.  The sweep times the CUDA kernel with CUDA
events, so here ``measure_config`` refuses the CPU and the sweep's tests
replace it with a deterministic fake."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import assert_bitwise, assert_ulp_close, to_t  # noqa: E402
from repro.core import comm as jax_comm  # noqa: E402
from repro.core import stencil as jst  # noqa: E402
from repro.core import tuning as jax_tuning  # noqa: E402
from repro.kernels.stencil_nd.fused import fused_ring_apply as jax_fused_ring_apply  # noqa: E402
from repro_torch.core import comm, operator, precision, stencil, tuning  # noqa: E402
from repro_torch.kernels.stencil_nd import kernel as stencil_kernel  # noqa: E402
from repro_torch.kernels.stencil_nd import ops  # noqa: E402
from repro_torch.kernels.stencil_nd.fused import fused_ring_apply  # noqa: E402
from repro_torch.kernels.stencil_nd.ops import ring_patch_apply, stencil_apply  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
FAB = tuning.RING_FABRIC


@pytest.fixture(autouse=True)
def _no_cache_file(monkeypatch, tmp_path):
    """No test reads a cache file it did not write."""
    monkeypatch.setenv(tuning.ENV_VAR, str(tmp_path / "absent.json"))
    metrics.reset()
    yield
    metrics.reset()


def _cfg(seg_len, chunk=1, itemsize=4, fuse_ring=False, nrhs=1):
    return tuning.KernelConfig(seg_len=seg_len, chunk=chunk,
                               tile=stencil_kernel.compiled_tile(itemsize), fuse_ring=fuse_ring,
                               nrhs=nrhs)


# ---------------------------------------------------------------------------
# Cache mechanics
# ---------------------------------------------------------------------------

def test_cache_key_format():
    assert tuning.cache_key("cpu", stencil.STAR7, F32, (48, 48, 32)) == "cpu/star7/float32/48x48x32"
    assert tuning.cache_key(torch.device("cpu"), stencil.get_spec("box27"), BF16,
                            (16, 8, 4)) == "cpu/box27/bfloat16/16x8x4"


def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "cache.json")
    cache = tuning.TuningCache(path)
    cfg = _cfg(8, fuse_ring=True)
    cache.put("cpu/star7/float32/16x8x32", cfg, {"best_seconds": 1e-3})
    cache.save()
    loaded = tuning.TuningCache.load(path)
    assert len(loaded) == 1 and loaded.get("cpu/star7/float32/16x8x32") == cfg
    assert loaded.entries["cpu/star7/float32/16x8x32"]["best_seconds"] == 1e-3
    assert json.loads(open(path).read())["format"] == tuning.CACHE_FORMAT


def test_cache_load_missing_or_corrupt_is_empty(tmp_path):
    assert len(tuning.TuningCache.load(str(tmp_path / "nope.json"))) == 0
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert len(tuning.TuningCache.load(str(bad))) == 0


def test_lookup_default_cache_and_stale():
    shape = (12, 10, 8)
    cfg, src = tuning.lookup_config(stencil.STAR7, F32, shape, device="cpu",
                                    cache=tuning.TuningCache(None))
    assert (cfg, src) == (tuning.default_config(stencil.STAR7, F32, shape), "default")
    assert not cfg.fuse_ring

    cache = tuning.TuningCache(None)
    tuned = _cfg(4, fuse_ring=True)
    cache.put(tuning.cache_key("cpu", stencil.STAR7, F32, shape), tuned)
    assert tuning.lookup_config(stencil.STAR7, F32, shape, device="cpu",
                                cache=cache) == (tuned, "cache")

    # entries the kernel cannot run: a segment longer than bx, a tile it was
    # not compiled for, an RHS chunk it has no instance for
    for bad in (_cfg(13), dataclasses_replace(tuned, tile=(8, 32)), _cfg(4, chunk=2)):
        cache.put(tuning.cache_key("cpu", stencil.STAR7, F32, shape), bad)
        with pytest.warns(UserWarning, match="stale"):
            cfg, src = tuning.lookup_config(stencil.STAR7, F32, shape, device="cpu",
                                            cache=cache)
        assert (cfg, src) == (tuning.default_config(stencil.STAR7, F32, shape), "stale")
    assert metrics.snapshot()["counters"] == {"tuning.lookup.default": 1,
                                              "tuning.lookup.cache": 1,
                                              "tuning.lookup.stale": 3}


def dataclasses_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


def test_lookup_ignores_batch_dim_and_device_keys_the_entry():
    cache = tuning.TuningCache(None)
    tuned = _cfg(8, chunk=4, itemsize=2, fuse_ring=True)
    cache.put(tuning.cache_key("cpu", stencil.STAR7, BF16, (60, 35, 96)), tuned)
    for shape in ((60, 35, 96), (4, 60, 35, 96)):
        assert tuning.lookup_config(stencil.STAR7, BF16, shape, device="cpu",
                                    cache=cache) == (tuned, "cache"), shape
    # an untuned batched block falls through to the default for its batch
    cfg, src = tuning.lookup_config(stencil.STAR7, BF16, (3, 12, 10, 8), device="cpu",
                                    cache=cache)
    assert (cfg, src) == (tuning.default_config(stencil.STAR7, BF16, (12, 10, 8), 3),
                          "default")
    # another card's entry is not this one's
    cache.entries["NVIDIA H100 80GB HBM3/star7/bfloat16/12x10x8"] = {"config": tuned.to_json()}
    assert tuning.lookup_config(stencil.STAR7, BF16, (12, 10, 8), device="cpu",
                                cache=cache)[1] == "default"


def test_env_var_disables_or_points_the_lookup(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.ENV_VAR, "off")
    assert tuning.resolve_cache_path() is None and tuning.get_cache() is None
    assert tuning.lookup_config(stencil.STAR7, F32, (8, 8, 8), device="cpu")[1] == "default"

    path = str(tmp_path / "cache.json")
    cache = tuning.TuningCache(path)
    tuned = _cfg(2, fuse_ring=True)
    cache.put(tuning.cache_key("cpu", stencil.STAR7, F32, (8, 8, 8)), tuned)
    cache.save()
    monkeypatch.setenv(tuning.ENV_VAR, path)
    assert tuning.lookup_config(stencil.STAR7, F32, (8, 8, 8), device="cpu") == (tuned, "cache")
    monkeypatch.delenv(tuning.ENV_VAR)
    assert tuning.resolve_cache_path() == "results/tuning_cache_torch.json"


# ---------------------------------------------------------------------------
# The default is today's plan; candidates; invalid configs
# ---------------------------------------------------------------------------

SHAPES = [(608, 608, 1536), (608, 608, 608), (48, 48, 32), (37, 29, 17), (1, 29, 17),
          (4, 29, 17)]


@pytest.mark.parametrize("specname", ["star7", "star13", "star25", "box27"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_default_config_is_todays_launch_plan(specname, dtype):
    spec = stencil.get_spec(specname)
    isz = torch.empty(0, dtype=dtype).element_size()
    for shape in SHAPES:
        for nb in (1, 2, 3, 4):
            plan = stencil_kernel.launch_plan(shape, nb, spec.n_offsets, spec.radius, isz)
            cfg = tuning.default_config(spec, dtype, shape, nb)
            assert (cfg.seg_len, cfg.chunk, cfg.tile, cfg.fuse_ring) == (
                plan.seg_len, plan.chunk, (plan.ty, plan.tz), False)
            assert stencil_kernel.launch_plan(shape, nb, spec.n_offsets, spec.radius, isz,
                                              cfg) == plan


@pytest.mark.parametrize("specname,nb", [("star7", 1), ("star7", 4), ("star25", 1),
                                         ("box27", 3), ("star13", 2)])
def test_candidates_default_first_and_valid(specname, nb):
    """The ring fold is a candidate only where the fabric has a ring: on one
    rank both forms run the same pad and kernel."""
    spec = stencil.get_spec(specname)
    shape = (48, 40, 32)
    for fabric, fuses in ((tuning.ONE_RANK, {False}), (FAB, {False, True})):
        cands = tuning.candidate_configs(spec, BF16, shape, nb, fabric)
        assert cands[0] == tuning.default_config(spec, BF16, shape, nb)
        assert len(cands) == len(set(cands))
        assert all(tuning.config_error(c, spec, BF16, shape) is None for c in cands)
        assert {c.fuse_ring for c in cands} == fuses
        assert {c.nrhs for c in cands} == {nb}
        assert {c.seg_len for c in cands} >= {8, 16, 32, 48}
        max_chunk = stencil_kernel.FAMILY[(spec.n_offsets, spec.radius)][1]
        assert {c.chunk for c in cands} == ({1, max_chunk} if nb > 1 else {1})
    assert tuning.candidate_configs(spec, BF16, shape, nb) == tuning.candidate_configs(
        spec, BF16, shape, nb, tuning.ONE_RANK)


def test_launch_plan_refuses_an_invalid_config():
    for bad, msg in [(_cfg(9), "x segment"), (_cfg(0), "x segment"),
                     (_cfg(4, chunk=3), "RHS chunk"),
                     (dataclasses_replace(_cfg(4), tile=(16, 128)), "tile")]:
        with pytest.raises(ValueError, match=msg):
            stencil_kernel.launch_plan((8, 8, 8), 3, 6, 1, 4, bad)
        # the wrapper checks it before the plain version runs, too
        v = torch.zeros((3, 10, 10, 10))
        with pytest.raises(ValueError, match=msg):
            stencil_kernel.stencil_nd_batched(v, [torch.zeros((8, 8, 8))] * 6,
                                              stencil.STAR7.offsets, radius=1, config=bad)


@pytest.mark.parametrize("specname", ["star7", "box27"])
def test_any_valid_config_gives_the_same_bits(specname):
    spec = stencil.get_spec(specname)
    shape = (9, 12, 16)
    gen = torch.Generator().manual_seed(0)
    cf = stencil.random_nonsymmetric(gen, shape, spec=spec)
    v = torch.randn((2,) + shape, generator=gen)
    base = stencil_apply(cf, v)
    for cfg in tuning.candidate_configs(spec, F32, shape, nb=2):
        assert_bitwise(stencil_apply(cf, v, config=cfg), base)


# ---------------------------------------------------------------------------
# The boundary-ring fold
# ---------------------------------------------------------------------------

def test_synthetic_exchange_layout():
    spec = stencil.STAR7
    v = torch.randn((2, 6, 8, 8), generator=torch.Generator().manual_seed(0))
    ex = tuning.synthetic_exchange(v, spec, FAB)
    r = spec.radius
    assert ex.n_batch == 1 and ex.shape == (6, 8, 8)
    assert_bitwise(ex.padded[:, r:-r, r:-r, r:-r], v)
    assert ex.padded[:, :r, r:-r, r:-r].abs().sum() > 0          # x halo filled
    assert ex.padded[:, r:-r, :r, r:-r].abs().sum() > 0          # y halo filled
    assert not ex.padded[:, r:-r, r:-r, :r].any()                # unsplit z halo zero


def _ring_cell(specname, dtype, shape, nb=0, seed=0):
    rng = np.random.default_rng(seed)
    spec = stencil.get_spec(specname)
    cfs = [rng.uniform(-0.2, 0.2, shape).astype(np.float32) for _ in spec.offsets]
    v = rng.standard_normal(((nb,) if nb else ()) + shape).astype(np.float32)
    r = spec.radius
    vp = np.pad(v, [(0, 0)] * (1 if nb else 0) + [(r, r)] * 3)
    for ax in (0, 1):                     # the split x and y halos carry values
        for side in (slice(0, r), slice(vp.shape[-3 + ax] - r, None)):
            reg = [slice(None)] * vp.ndim
            reg[vp.ndim - 3 + ax] = side
            vp[tuple(reg)] = rng.standard_normal(vp[tuple(reg)].shape)
    return spec, cfs, v, vp


@pytest.mark.parametrize("specname", ["star7", "star25", "box27"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nb", [0, 2], ids=["unbatched", "batched"])
def test_fused_ring_bitwise_identical_to_split(specname, dtype, nb):
    shape = (8, 8, 8) if specname == "star25" else (6, 8, 8)
    spec, cfs, v, vp = _ring_cell(specname, dtype, shape, nb)
    cl = [torch.from_numpy(c).to(dtype) for c in cfs]
    vt, vpt = torch.from_numpy(v).to(dtype), torch.from_numpy(vp).to(dtype)
    ex = comm.HaloExchange(vt, FAB, spec.radius, spec.needs_corners, int(nb > 0), filled=vpt)
    assert len(comm.boundary_regions(ex.shape, FAB, spec.radius)) == 4
    isz = torch.empty(0, dtype=dtype).element_size()
    for cfg in (None, _cfg(2, itemsize=isz, fuse_ring=True)):
        u_fused = fused_ring_apply(ex, cl, spec, cfg, accum_dtype=dtype)
        u_int = ops._kernel(ex.n_batch)(torch.nn.functional.pad(vt, (spec.radius,) * 6), cl,
                                        spec.offsets, radius=spec.radius, accum_dtype=dtype,
                                        config=cfg)
        u_split = ring_patch_apply(ex, cl, spec, u_int, FAB, accum_dtype=dtype, config=cfg)
        assert u_fused.dtype == u_split.dtype == dtype
        assert_bitwise(u_fused, u_split)


@pytest.mark.parametrize("specname", ["star7", "star25", "box27"])
def test_fused_ring_matches_the_reference(specname):
    """The port's fold against the JAX package's (Pallas, interpret mode) on
    the same exchanged block, f32: within 2 ulp of each sum's largest term
    (XLA contracts the reference's multiply-adds into FMAs; the port does not)."""
    shape = (8, 8, 8) if specname == "star25" else (6, 8, 8)
    spec, cfs, v, vp = _ring_cell(specname, F32, shape, seed=3)
    jspec = jst.get_spec(specname)
    jex = jax_comm.HaloExchange(padded=jnp.asarray(vp), radius=spec.radius, shape=shape)
    want = jax_fused_ring_apply(jex, [jnp.asarray(c) for c in cfs], jspec,
                                jax_tuning.KernelConfig(block=shape[:2], zc=shape[2]),
                                interpret=True)
    ex = comm.HaloExchange(to_t(v), FAB, spec.radius, spec.needs_corners, filled=to_t(vp))
    got = fused_ring_apply(ex, [to_t(c) for c in cfs], spec, None)
    r = spec.radius
    scale = np.abs(vp[r:-r, r:-r, r:-r]).astype(np.float64)
    for c, off in zip(cfs, spec.offsets):
        win = vp[tuple(slice(r + o, r + o + n) for o, n in zip(off, shape))]
        scale = np.maximum(scale, np.abs(c * win))
    assert_ulp_close(got, np.asarray(jax.device_get(want)), scale * spec.n_points)


# ---------------------------------------------------------------------------
# The operator resolves the cache once, at build
# ---------------------------------------------------------------------------

def _spy_configs(monkeypatch):
    seen = []
    for module in (ops, stencil_kernel):      # the split forms call ops', the fold kernel's
        for name in ("stencil_nd", "stencil_nd_batched"):
            real = getattr(stencil_kernel, name)

            def spy(*a, real=real, **kw):
                seen.append(kw.get("config"))
                return real(*a, **kw)

            monkeypatch.setattr(module, name, spy)
    planned = []
    real_plan = stencil_kernel.launch_plan

    def plan_spy(*a, **kw):
        planned.append(a[5] if len(a) > 5 else kw.get("config"))
        return real_plan(*a, **kw)

    monkeypatch.setattr(stencil_kernel, "launch_plan", plan_spy)
    return seen, planned


@pytest.mark.parametrize("schedule", ["overlap", "blocking"])
def test_fused_operator_passes_the_cached_config(tmp_path, monkeypatch, schedule):
    shape = (6, 8, 8)
    gen = torch.Generator().manual_seed(1)
    cf = stencil.random_nonsymmetric(gen, shape)
    v = torch.randn((2,) + shape, generator=gen)
    seen, planned = _spy_configs(monkeypatch)
    plain = operator.make_operator("fused", cf, policy=precision.F32,
                                   schedule=schedule).apply(v)
    assert seen and all(c is None for c in seen) and planned == []    # today's plan

    tuned = _cfg(2, chunk=4, fuse_ring=True)
    path = str(tmp_path / "cache.json")
    cache = tuning.TuningCache(path)
    cache.put(tuning.cache_key("cpu", stencil.STAR7, F32, shape), tuned)
    cache.save()
    monkeypatch.setenv(tuning.ENV_VAR, path)
    seen.clear()
    op = operator.make_operator("fused", cf, policy=precision.F32, schedule=schedule)
    assert metrics.snapshot()["counters"]["tuning.lookup.cache"] == 1
    got = op.apply(v)
    op.apply(v[0])
    assert len(seen) == 2 and all(c == tuned for c in seen)
    assert planned and all(c == tuned for c in planned)
    assert metrics.snapshot()["counters"]["tuning.lookup.cache"] == 1    # once, at build
    assert_bitwise(got, plain)


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def _fake_measure(spec, dtype, shape, config, **kw):
    return 1e-3 * (1 + config.seg_len / 100) * (0.5 if config.fuse_ring else 1.0)


@pytest.mark.parametrize("nrhs", [1, 2])
@pytest.mark.parametrize("ring", [False, True], ids=["one_rank", "split_fabric"])
def test_autotune_cell_sweeps_saves_then_hits(tmp_path, monkeypatch, nrhs, ring):
    def fake(spec, dtype, shape, config, **kw):     # the whole block, folded, wins
        return 1e-3 * (1 + 1 / config.seg_len) * (0.5 if config.fuse_ring else 1.0)

    monkeypatch.setattr(tuning, "measure_config", fake)
    path = str(tmp_path / "cache.json")
    spec, shape = stencil.STAR7, (16, 8, 8)
    fabric = FAB if ring else tuning.ONE_RANK
    rec = tuning.autotune_cell(spec, F32, shape, nrhs=nrhs, fabric=fabric,
                               cache=tuning.TuningCache(path), device="cpu")
    cands = tuning.candidate_configs(spec, F32, shape, nrhs, fabric)
    assert not rec["cache_hit"] and rec["n_candidates"] == len(cands)
    fastest = min(cands, key=lambda c: fake(spec, F32, shape, c))
    assert fastest.seg_len == 16 != cands[0].seg_len
    assert fastest.fuse_ring == ring and rec["config"] == fastest.to_json()
    assert rec["fabric"] == [fabric.nx, fabric.ny, fabric.nz] and rec["config"]["nrhs"] == nrhs
    assert rec["speedup_vs_default"] > 1 and rec["card"] is None
    assert rec["bound_s"] == tuning.spmv_bytes(spec, F32, shape, nrhs) / 3.35e12
    assert all(s["bitwise_default"] for s in rec["swept"])
    assert rec["swept"][0]["config"] == rec["default_config"]

    monkeypatch.setenv(tuning.ENV_VAR, path)
    again = tuning.ensure_tuned(spec, F32, shape, nrhs=nrhs, fabric=fabric, device="cpu")
    assert again["cache_hit"] and again["config"] == rec["config"]
    cfg, src = tuning.lookup_config(spec, F32, shape, device="cpu")
    assert src == "cache" and cfg.to_json() == rec["config"]
    assert metrics.snapshot()["counters"]["tuning.sweep.cache_hit"] == 1


def _plan_spy(monkeypatch):
    plans = []
    real = stencil_kernel.launch_plan

    def spy(*a, **kw):
        plan = real(*a, **kw)
        plans.append((a[1], plan.chunk))
        return plan

    monkeypatch.setattr(stencil_kernel, "launch_plan", spy)
    return plans


def test_entry_swept_at_one_batch_keeps_the_default_chunk_at_another(tmp_path, monkeypatch):
    """A single-RHS sweep's chunk (1) never reaches a 4-RHS launch, which
    keeps the family maximum; the single-RHS launch takes the entry."""
    monkeypatch.setattr(tuning, "measure_config", _fake_measure)
    spec, shape = stencil.STAR7, (8, 8, 8)
    path = str(tmp_path / "cache.json")
    rec = tuning.autotune_cell(spec, F32, shape, nrhs=1, cache=tuning.TuningCache(path),
                               device="cpu")
    assert rec["config"]["chunk"] == 1 and rec["config"]["nrhs"] == 1
    monkeypatch.setenv(tuning.ENV_VAR, path)
    gen = torch.Generator().manual_seed(2)
    cf = stencil.random_nonsymmetric(gen, shape)
    op = operator.make_operator("fused", cf, policy=precision.F32)
    plans = _plan_spy(monkeypatch)
    op.apply(torch.randn((4,) + shape, generator=gen))
    op.apply(torch.randn(shape, generator=gen))
    max_chunk = stencil_kernel.FAMILY[(spec.n_offsets, spec.radius)][1]
    assert plans == [(4, max_chunk), (1, 1)]


def test_batched_entry_chunk_serves_only_its_batch(tmp_path, monkeypatch):
    """The reverse: a 4-RHS sweep whose winner has chunk 1 hands chunk 1 to
    4-RHS launches only; 2 RHS keep the default chunk."""
    monkeypatch.setattr(tuning, "measure_config",
                        lambda spec, dtype, shape, config, **kw: 1e-3 * config.chunk)
    spec, shape = stencil.STAR7, (8, 8, 8)
    path = str(tmp_path / "cache.json")
    rec = tuning.autotune_cell(spec, F32, shape, nrhs=4, cache=tuning.TuningCache(path),
                               device="cpu")
    assert rec["config"]["chunk"] == 1 and rec["config"]["nrhs"] == 4
    monkeypatch.setenv(tuning.ENV_VAR, path)
    gen = torch.Generator().manual_seed(3)
    op = operator.make_operator("fused", stencil.random_nonsymmetric(gen, shape),
                                policy=precision.F32)
    plans = _plan_spy(monkeypatch)
    op.apply(torch.randn((4,) + shape, generator=gen))
    op.apply(torch.randn((2,) + shape, generator=gen))
    assert plans == [(4, 1), (2, stencil_kernel.FAMILY[(6, 1)][1])]


def test_autotune_at_another_batch_sweeps_again(tmp_path, monkeypatch):
    """An entry swept at one batch is no cache hit for another: the sweep
    runs again and the entry names the new batch."""
    monkeypatch.setattr(tuning, "measure_config", _fake_measure)
    spec, shape = stencil.STAR7, (8, 8, 8)
    cache = tuning.TuningCache(str(tmp_path / "cache.json"))
    first = tuning.autotune_cell(spec, F32, shape, nrhs=1, cache=cache, device="cpu")
    second = tuning.autotune_cell(spec, F32, shape, nrhs=4, cache=cache, device="cpu")
    third = tuning.autotune_cell(spec, F32, shape, nrhs=4, cache=cache, device="cpu")
    assert not first["cache_hit"] and not second["cache_hit"] and third["cache_hit"]
    assert second["key"] == first["key"] and cache.get(first["key"]).nrhs == 4
    assert metrics.snapshot()["counters"]["tuning.sweep.runs"] == 2


def test_autotune_refuses_a_config_that_changes_bits(monkeypatch):
    monkeypatch.setattr(tuning, "measure_config", _fake_measure)
    real = tuning.config_apply

    def off_by_one_bit(problem, spec, config):
        u = real(problem, spec, config)
        return u if config.seg_len != 8 else torch.nextafter(u, u + 1)

    monkeypatch.setattr(tuning, "config_apply", off_by_one_bit)
    with pytest.raises(RuntimeError, match="other bits"):
        tuning.autotune_cell(stencil.STAR7, F32, (16, 8, 8), cache=tuning.TuningCache(None),
                             device="cpu", save=False)


def test_measure_config_refuses_the_cpu():
    cfg = tuning.default_config(stencil.STAR7, F32, (8, 8, 8))
    with pytest.raises(ValueError, match="plain version"):
        tuning.measure_config(stencil.STAR7, F32, (8, 8, 8), cfg, device="cpu")
    problem = tuning.cell_problem(stencil.STAR7, F32, (8, 8, 8), device="cpu")
    with pytest.raises(ValueError, match="CUDA events"):
        tuning.measure_config(stencil.STAR7, F32, (8, 8, 8), cfg, problem=problem)


def test_cli_autotune_on_the_cpu_exits_with_a_reason():
    from repro_torch.launch import solve

    with pytest.raises(SystemExit, match="needs the card"):
        solve.main(["--device", "cpu", "--autotune"])


def test_no_warning_from_a_clean_lookup():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tuning.lookup_config(stencil.STAR7, F32, (8, 8, 8), device="cpu")
