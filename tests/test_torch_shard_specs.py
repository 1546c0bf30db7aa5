"""The port's mesh half of the LM substrate (``models/param.py``,
``models/model.py``'s abstract stand-ins, ``launch/mesh.py``) against the
JAX package's, exactly: every leaf's ``physical_spec`` and ``zero1_spec``,
the spec trees, the abstract shapes and dtypes, for the ten full-width
architectures under their own ``rules`` on the production meshes (16, 16)
and (2, 16, 16) and on (2, 2) and (1, 1).  The reference side reads its
specs off ``jax.sharding.AbstractMesh`` (no devices); the port's off a
``RankMesh`` of the same axes.  Then ``shard_leaf``/``gather_leaf`` across
four gloo ranks on the CPU, and the recording mode of ``core.dist.MeshComm``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import run_with_ranks

torch.set_num_threads(1)

ARCHS = ["paligemma_3b", "stablelm_12b", "gemma3_12b", "qwen2_1_5b", "deepseek_7b",
         "rwkv6_7b", "qwen2_moe_a2_7b", "grok_1_314b", "whisper_large_v3", "jamba_v0_1_52b"]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2": (("data", "model"), (2, 2)),
          "1x1": (("data", "model"), (1, 1))}
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def meshes(name: str):
    from jax.sharding import AbstractMesh

    from repro_torch.launch.mesh import RankMesh

    axes, extents = MESHES[name]
    return AbstractMesh(extents, axes), RankMesh(axes, extents)


def jax_leaves(tree, leaf_type=None) -> dict:
    """``path -> leaf`` of a JAX pytree, paths written as the port's
    ``tree_leaves`` writes them (``layers/pos0/attn/wq``)."""
    import jax

    def name(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    is_leaf = None if leaf_type is None else (lambda x: isinstance(x, leaf_type))
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(name(k) for k in path): leaf for path, leaf in flat}


def port_leaves(tree) -> dict:
    from repro_torch.models.param import tree_leaves

    return dict(tree_leaves(tree))


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) else np.dtype(dt).name


def same_spec(port_spec, jax_spec) -> bool:
    return type(port_spec).__name__ == "Spec" and tuple(port_spec) == tuple(jax_spec)


def both_configs(arch: str):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    return jget(arch), tget(arch)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_equal_the_references(arch, mesh_name):
    from repro.models import model as JM
    from repro.models import param as JP
    from repro.models import transformer as JT
    from repro_torch.models import model as TM
    from repro_torch.models import param as TP
    from repro_torch.models import transformer as TT

    jc, tc = both_configs(arch)
    jmesh, tmesh = meshes(mesh_name)
    jdefs = jax_leaves(JT.build_model_defs(jc), JP.ParamDef)
    tdefs = port_leaves(TT.build_model_defs(tc))
    assert list(jdefs) == list(tdefs)
    with JP.rule_overrides(dict(jc.rules)), TP.rule_overrides(dict(tc.rules)):
        jtree = jax_leaves(JM.param_shardings(jc, jmesh))
        ttree = port_leaves(TM.param_shardings(tc, tmesh))
        jz1 = jax_leaves(JP.zero1_sharding_tree(JT.build_model_defs(jc), jmesh))
        tz1 = port_leaves(TP.zero1_sharding_tree(TT.build_model_defs(tc), tmesh))
        jabs = jax_leaves(JM.abstract_params(jc, jmesh))
        tabs = port_leaves(TM.abstract_params(tc, tmesh))
        for path, jd in jdefs.items():
            td = tdefs[path]
            assert (td.shape, td.axes) == (jd.shape, jd.axes), path
            jp = JP.physical_spec(jd.shape, jd.axes, jmesh)
            tp = TP.physical_spec(td.shape, td.axes, tmesh)
            assert same_spec(tp, jp), (path, tp, jp)
            jz = JP.zero1_spec(jd.shape, jd.axes, jmesh)
            tz = TP.zero1_spec(td.shape, td.axes, tmesh)
            assert same_spec(tz, jz), (path, tz, jz)
            assert same_spec(ttree[path], jtree[path].spec), path
            assert same_spec(tz1[path], jz1[path].spec), path
            a, b = tabs[path], jabs[path]
            assert a.device.type == "meta" and tuple(a.shape) == tuple(b.shape), path
            assert dtype_name(a.dtype) == dtype_name(b.dtype), path
            assert same_spec(a.spec, b.sharding.spec), path


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_caches_and_optimizer_specs_equal_the_references(arch, mesh_name):
    from repro.models import model as JM
    from repro.models import param as JP
    from repro_torch.models import model as TM
    from repro_torch.models import param as TP

    jc, tc = both_configs(arch)
    jmesh, tmesh = meshes(mesh_name)

    def held(jtree, ttree, spec_of=lambda x: x.sharding.spec, what=""):
        j, t = jax_leaves(jtree), port_leaves(ttree)
        assert list(j) == list(t), what
        for path, b in j.items():
            a = t[path]
            assert tuple(a.shape) == tuple(b.shape), (what, path)
            assert dtype_name(a.dtype) == dtype_name(b.dtype), (what, path)
            if spec_of is not None:
                assert same_spec(a.spec, spec_of(b)), (what, path, a.spec, spec_of(b))

    with JP.rule_overrides(dict(jc.rules)), TP.rule_overrides(dict(tc.rules)):
        for name in SHAPES:
            js, ts = JM.SHAPES[name], TM.SHAPES[name]
            assert dataclasses.astuple(js) == dataclasses.astuple(ts)
            held(JM.input_specs(jc, js, jmesh), TM.input_specs(tc, ts, tmesh), what=name)
            if ts.kind != "train":
                held(JM.abstract_caches(jc, js, jmesh), TM.abstract_caches(tc, ts, tmesh),
                     what=f"caches {name}")
        jo, to = JM.abstract_opt_state(jc, jmesh), TM.abstract_opt_state(tc, tmesh)
        held(jo.mu, to.mu, what="mu")
        held(jo.nu, to.nu, what="nu")
        assert tuple(to.count.shape) == () and to.count.dtype == torch.int32
        jps, jopt, jm = JM.out_shardings_for_train(jc, jmesh)
        tps, topt, tm = TM.out_shardings_for_train(tc, tmesh)
        for jt, tt in ((jps, tps), (jopt.mu, topt.mu), (jopt.nu, topt.nu)):
            j, t = jax_leaves(jt), port_leaves(tt)
            assert list(j) == list(t)
            assert all(same_spec(t[k], v.spec) for k, v in j.items())
        assert same_spec(topt.count, jopt.count.spec)
        assert set(tm) == set(jm) and all(same_spec(tm[k], jm[k].spec) for k in jm)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_the_references(multi_pod, monkeypatch):
    from repro.launch import mesh as JMesh
    from repro_torch.launch import mesh as TMesh

    # the reference builds a mesh of 256 (512) devices; its shape and axes
    # are read where it hands them to jax.make_mesh
    monkeypatch.setattr(JMesh, "_make_mesh", lambda shape, axes: (tuple(axes), tuple(shape)))
    tm = TMesh.make_production_mesh(multi_pod=multi_pod)
    assert (tm.axis_names, tm.extents) == JMesh.make_production_mesh(multi_pod=multi_pod)
    assert tm.size == (512 if multi_pod else 256) and tm.rank == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_config_fields_equal_the_references(arch):
    from repro.models import model as JM
    from repro_torch.models import model as TM

    jc, tc = both_configs(arch)
    fields = ("name", "n_layers", "n_enc_layers", "unroll", "remat", "attn_block",
              "inner_unroll")
    for k in (1, 2):
        for T in (None, 4096, 128, 524288):
            a, b = TM.probe_config(tc, k, T), JM.probe_config(jc, k, T)
            assert {f: getattr(a, f) for f in fields} == {f: getattr(b, f) for f in fields}
            assert a.remat is False and a.n_periods == k


def test_specs_of_a_two_by_two_mesh_split_whole_blocks():
    """Every leaf's blocks on 2x2 tile it: the four ranks' slices cover each
    element as often as the spec replicates it."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import transformer as TT
    from repro_torch.models.param import block_slices, physical_spec, tree_leaves, zero1_spec

    cfg = get_smoke("qwen2_moe_a2_7b")
    for _, d in tree_leaves(TT.build_model_defs(cfg)):
        for fn in (physical_spec, zero1_spec):
            spec = fn(d.shape, d.axes, RankMesh(("data", "model"), (2, 2)))
            cover = np.zeros(d.shape, np.int64)
            for r in range(4):
                cover[block_slices(d.shape, spec, RankMesh(("data", "model"), (2, 2), r))] += 1
            split = int(np.prod([{"data": 2, "model": 2}[a] for a in spec.mesh_axes()]))
            assert (cover == 4 // split).all(), (d, spec)


def _round_trip_ranks():
    """Each rank cuts its blocks of full tensors under several specs and
    puts them back with ``gather_leaf``; then a reduce-scatter and an
    all-reduce over each axis set against the sums of every rank's tensor."""
    import torch

    from repro_torch.core import dist
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models.param import Spec, gather_leaf, shard_leaf

    mesh = RankMesh(("data", "model"), (2, 2), dist.rank())
    comm = dist.MeshComm(mesh)
    g = torch.Generator().manual_seed(7)
    full = torch.randn(8, 6, 4, generator=g).to(torch.bfloat16)
    specs = [Spec(), Spec("model"), Spec(None, "data"), Spec("data", "model"),
             Spec(("data", "model")), Spec(("model", "data")), Spec(None, None, "model")]
    for spec in specs:
        block = shard_leaf(full, spec, mesh)
        back = gather_leaf(block, spec, mesh, comm)
        assert torch.equal(back, full), spec
    mine = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (1 + dist.rank())
    every = [torch.arange(24, dtype=torch.float32).reshape(4, 6) * (1 + r) for r in range(4)]
    c = mesh.coords
    for axes in (("data",), ("model",), ("data", "model"), ("model", "data")):
        members = [r for r in range(4)
                   if all(RankMesh(mesh.axis_names, mesh.extents, r).coords[a] == c[a]
                          for a in mesh.axis_names if a not in axes)]
        want = sum(every[r] for r in members)
        assert torch.equal(comm.all_reduce_sum(mine, axes), want), axes
        at = 0
        for a in axes:
            at = at * 2 + c[a]
        part = comm.reduce_scatter(mine, axes, dim=0)
        n = 4 // len(members)
        assert torch.equal(part, want[at * n:(at + 1) * n]), axes
    print("ok", dist.rank(), comm.collectives)


def test_shard_and_gather_round_trip_across_four_gloo_ranks(tmp_path):
    outs = run_with_ranks(_round_trip_ranks, 4, tmp_path, timeout=120)
    assert all(o.startswith("ok") for o in outs), outs


def test_recording_mode_logs_collectives_and_returns_shapes():
    from repro_torch.core.dist import MeshComm
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models.param import Spec, gather_leaf

    log: list = []
    mesh = RankMesh(("data", "model"), (16, 16))
    comm = MeshComm(mesh, record=log)
    block = torch.empty(4, 96, dtype=torch.bfloat16, device="meta")
    full = gather_leaf(block, Spec("data", "model"), mesh, comm)
    assert tuple(full.shape) == (64, 1536) and full.device.type == "meta"
    s = comm.all_reduce_sum(torch.empty(10, device="meta"), ("data",))
    part = comm.reduce_scatter(torch.empty(32, 8, device="meta"), ("data",), dim=0)
    assert tuple(s.shape) == (10,) and tuple(part.shape) == (2, 8)
    assert [(e["op"], e["bytes"], e["group"]) for e in log] == [
        ("all-gather", 64 * 96 * 2, 16), ("all-gather", 64 * 1536 * 2, 16),
        ("all-reduce", 40, 16), ("reduce-scatter", 2 * 8 * 4, 16)]
    one = MeshComm(RankMesh(("data", "model"), (1, 1)), record=log)
    assert one.all_reduce_sum(torch.ones(3), ("data",)).tolist() == [1.0, 1.0, 1.0]
    assert len(log) == 4       # a group of one moves nothing and logs nothing
    # ring link bytes: all-gather and reduce-scatter (g-1)/g of the full
    # tensor, all-reduce twice that
    assert [e["link_bytes"] for e in log] == [
        64 * 96 * 2 * 15 / 16, 64 * 1536 * 2 * 15 / 16, 40 * 2 * 15 / 16, 32 * 8 * 4 * 15 / 16]
