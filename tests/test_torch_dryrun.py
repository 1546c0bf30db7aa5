"""The port's dry-run (``launch/dryrun.py``) and its memory model
(``launch/roofline_model.py``) against the JAX package's.

* ``roofline_model``'s ``est_*`` byte counts equal the reference's exactly,
  for the ten architectures x the four ``LM_SHAPES`` on both production
  meshes, under each config's ``rules``; only the card's memory differs
  (``hbm_bytes``, ``est_fits_hbm`` against the reference's 16 GiB
  ``est_fits_16gb``).
* The probes' depth extrapolation equals a whole trace of the same depth,
  exactly (FLOPs, bytes, collectives), on a 1 x 1 mesh; RWKV's bilinear
  depth x sequence form exactly in FLOPs and collectives, and in bytes to
  the part its chunk loop's backward adds quadratically in the chunk count.  On a split mesh
  it need not: ZeRO-1 picks the largest free dimension its axes divide,
  and a stacked leaf's leading dimension is the depth, so the choice (and
  the bytes) can change with the number of periods — as it does in the
  reference's probes.
* The meta FLOP count of Qwen2-1.5B's train step at 2 x 4,096 on a 1 x 1
  mesh equals ``chip_smoke.py:train_bounds`` less one product per layer,
  exactly: ``train_bounds`` counts a whole remat forward (2 N tokens), and
  the port's non-reentrant checkpoint stops recomputing a block once the
  backward's saved tensors are back, so each block's last product (the
  MLP's down projection, its output saved by nothing) is not recomputed:
  120.43 - 6.31 = 114.11 TFLOP.
* Every smoke config, the MoE's among them, traces on ``meta`` (train,
  prefill, decode) on a 2 x 2 mesh, its collectives recorded.
* A CLI cell writes its record, with the H100 roofline terms.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys

import pytest
import torch

from _torch_port import REPO, run_module

torch.set_num_threads(1)

ARCHS = ["paligemma_3b", "stablelm_12b", "gemma3_12b", "qwen2_1_5b", "deepseek_7b",
         "rwkv6_7b", "qwen2_moe_a2_7b", "grok_1_314b", "whisper_large_v3", "jamba_v0_1_52b"]
LM_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _est_pair(arch: str, shape: str, multi_pod: bool):
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget
    from repro.launch.roofline_model import lm_cell_memory_estimate as jest
    from repro.models import model as JM
    from repro.models.param import rule_overrides as jrules
    from repro_torch.configs import get_config as tget
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline_model import lm_cell_memory_estimate as test_
    from repro_torch.models import model as TM
    from repro_torch.models.param import rule_overrides as trules

    jc, tc = jget(arch), tget(arch)
    tm = make_production_mesh(multi_pod=multi_pod)
    jm = AbstractMesh(tm.extents, tm.axis_names)
    with jrules(dict(jc.rules)), trules(dict(tc.rules)):
        return jest(jc, JM.SHAPES[shape], jm), test_(tc, TM.SHAPES[shape], tm)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", LM_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_memory_estimates_equal_the_references(arch, shape, multi_pod):
    from repro_torch.launch.roofline_model import HBM_PER_CARD

    ref, got = _est_pair(arch, shape, multi_pod)
    assert set(ref) - {"est_fits_16gb"} == set(got) - {"est_fits_hbm", "hbm_bytes"}
    for k in ref:
        if k != "est_fits_16gb":
            assert got[k] == ref[k], (k, got[k], ref[k])
    assert got["hbm_bytes"] == HBM_PER_CARD == 80 * 10 ** 9
    assert got["est_fits_hbm"] == (got["est_footprint_bytes"] < HBM_PER_CARD)


@pytest.mark.parametrize("cell", ["cs1_paper", "joule_600", "joule_370"])
def test_stencil_estimates_equal_the_references(cell):
    from repro.launch.roofline_model import stencil_cell_memory_estimate as jest
    from repro_torch.configs.stencil_cs1 import STENCIL_CELLS
    from repro_torch.launch.roofline_model import stencil_cell_memory_estimate as test_

    shape = STENCIL_CELLS[cell].mesh_shape
    for grid in ((16, 16, 1), (16, 16, 2)):
        ref, got = jest(shape, grid, itemsize=2), test_(shape, grid, itemsize=2)
        for k in ref:
            if k != "est_fits_16gb":
                assert got[k] == ref[k], (cell, k)


def _one_by_one():
    from repro_torch.launch.mesh import RankMesh

    return RankMesh(("data", "model"), (1, 1))


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "qwen2_moe_a2_7b", "gemma3_12b",
                                  "whisper_large_v3", "paligemma_3b", "jamba_v0_1_52b"])
def test_probe_extrapolation_equals_a_whole_trace(arch):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as TM

    cfg = get_smoke(arch)
    shape = dataclasses.replace(TM.SHAPES["smoke_train"], global_batch=2)
    mesh = _one_by_one()
    depth = 3
    whole = D.trace_cell(TM.probe_config(cfg, depth, shape.seq_len), shape, mesh)
    c1 = D.trace_cell(TM.probe_config(cfg, 1, shape.seq_len), shape, mesh)
    c2 = D.trace_cell(TM.probe_config(cfg, 2, shape.seq_len), shape, mesh)
    got = D.extrapolate(c1, c2, depth)
    assert {k: got[k] for k in D.COST_KEYS} == {k: whole[k] for k in D.COST_KEYS}
    assert c2["flops"] > c1["flops"] > 0 and c2["bytes"] > c1["bytes"]


def test_rwkv_bilinear_extrapolation_equals_a_whole_trace():
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as TM

    cfg = get_smoke("rwkv6_7b")
    mesh = _one_by_one()
    base = dataclasses.replace(TM.SHAPES["smoke_train"], global_batch=2)
    Ta, Tb, T, depth = 2 * cfg.rwkv_chunk, 4 * cfg.rwkv_chunk, 6 * cfg.rwkv_chunk, 3

    def cv(k, t):
        return D.trace_cell(TM.probe_config(cfg, k, t), dataclasses.replace(base, seq_len=t),
                            mesh)

    got = D.bilinear(cv(1, Ta), cv(2, Ta), cv(1, Tb), cv(2, Tb), Ta, Tb, T, depth)
    whole = cv(depth, T)
    for k in ("flops", "n_collectives"):
        assert got[k] == whole[k], (k, got[k], whole[k])
    # the bytes are not affine in T: the backward of the chunk loop's
    # per-chunk ``select`` writes a zero gradient of the whole sequence for
    # every chunk and adds it up (``select_backward`` + ``add``), bytes
    # quadratic in the chunk count; at 6 chunks 0.13% of the step's
    assert 0 < whole["bytes"] - got["bytes"] < 0.005 * whole["bytes"]


def test_meta_flops_of_the_full_width_train_step_match_train_bounds():
    sys.path.insert(0, REPO)
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as TM

    cfg = get_config("qwen2_1_5b")
    B, T = 2, 4096
    shape = dataclasses.replace(TM.SHAPES["train_4k"], global_batch=B)
    got = D.trace_cell(cfg, shape, _one_by_one())
    bounds = chip_smoke.train_bounds(cfg, B, T)
    down_recompute = 2 * cfg.d_model * cfg.d_ff * B * T * cfg.n_layers
    assert got["flops"] == bounds["train_flops"] - down_recompute
    assert abs(got["flops"] / 1e12 - 114.11) < 0.01
    assert got["n_collectives"] == 0 and got["bytes"] > 0
    # with no remat the trace is the forward and the backward alone: 6 N
    # tokens and three passes of the attention products
    plain = D.trace_cell(dataclasses.replace(cfg, remat=False), shape, _one_by_one())
    layers = bounds["train_flops"] - bounds["attention_flops"] - 6 * cfg.d_model * cfg.vocab \
        * B * T
    assert plain["flops"] == (bounds["train_flops"] - layers // 4
                              - bounds["attention_flops"] // 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_smoke_config_traces_on_meta_across_ranks(arch):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import model as TM

    cfg = get_smoke(arch)
    mesh = RankMesh(("data", "model"), (2, 2))
    for name in ("smoke_train", "smoke_prefill", "smoke_decode"):
        shape = dataclasses.replace(TM.SHAPES[name], global_batch=4)
        c = D.trace_cell(cfg, shape, mesh)
        assert c["flops"] > 0 and c["bytes"] > 0 and c["peak_live_bytes"] > c["input_bytes"]
        ops = c["collectives"]
        assert ops["all-gather"]["count"] > 0, (arch, name, ops)
        if name == "smoke_train":
            assert ops["reduce-scatter"]["count"] > 0 and ops["all-reduce"]["count"] >= 3
        if cfg.n_experts and name != "smoke_decode":
            # the global choice counts of every MoE layer's load-balancing loss
            assert ops["all-reduce"]["count"] >= sum(s.moe for s in cfg.layer_specs())


def test_stencil_cell_is_perfmodels_iteration_on_one_rank():
    from repro_torch.core import perfmodel
    from repro_torch.launch import dryrun as D

    rec = D.lower_stencil_cell("cs1_paper", False)
    pts = 608 * 608 * 1536 // 256
    assert rec["per_chip_flops"] == 44 * pts and rec["model_flops_global"] == 44 * pts * 256
    model = perfmodel.iteration_time_model((608, 608, 1536), 256, itemsize=2, hop_latency_s=0.0)
    assert math.isclose(rec["t_compute_s"], model["t_compute_s"], rel_tol=1e-12)
    slabs = 2 * (2 * 38 * 1536 + 2 * 38 * 1536) * 2
    assert rec["per_chip_bytes"] == 42 * 2 * pts + 2 * slabs
    assert rec["collectives"]["collective-permute"]["count"] == 8
    assert rec["collectives"]["all-reduce"]["count"] == 3
    assert rec["dominant"] == "memory" and rec["status"] == "ok"


def test_no_tpu_constant_in_the_port():
    for rel in ("src/repro_torch/launch/dryrun.py", "src/repro_torch/launch/roofline_model.py"):
        text = open(os.path.join(REPO, rel)).read()
        for tpu in ("197e12", "819e9", "16 * 2 ** 30", "v5e"):
            assert tpu not in text, (rel, tpu)
    from repro_torch.launch import dryrun as D

    assert (D.PEAK_FLOPS, D.HBM_BW, D.NVLINK_BW, D.NODE_LINK_BW) == (989e12, 3.35e12, 450e9,
                                                                      50e9)


def test_cli_cell_writes_its_record(tmp_path):
    out = tmp_path / "dryrun"
    res = run_module("repro_torch.launch.dryrun", "--arch", "qwen2_1_5b", "--shape",
                     "decode_32k", "--mesh", "single", "--out", str(out), timeout=300)
    assert res.returncode == 0, res.stderr
    assert "1 ok, 0 skipped, 0 errors" in res.stdout
    rec = json.loads((out / "qwen2_1_5b__decode_32k__pod1.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["n_devices"] == 256
    for k in ("per_chip_flops", "per_chip_bytes", "coll_link_bytes", "t_compute_s",
              "t_memory_s", "t_collective_s", "t_bound_s", "dominant", "probe1_cost",
              "probe2_cost", "whole_trace", "est_footprint_bytes", "est_fits_hbm"):
        assert k in rec, k
    assert rec["probe_mode"] == "depth" and rec["per_chip_flops"] > 0
    assert rec["t_compute_s"] == rec["per_chip_flops"] / 989e12
    assert rec["whole_trace"]["collectives"]["all-gather"]["count"] > 0
    ref, _ = _est_pair("qwen2_1_5b", "decode_32k", False)
    assert all(rec[k] == ref[k] for k in ref if k != "est_fits_16gb")
    again = run_module("repro_torch.launch.dryrun", "--arch", "stencil:joule_370", "--mesh",
                       "pod", "--out", str(out), timeout=300)
    assert again.returncode == 0, again.stderr
    st = json.loads((out / "joule_370__bicgstab_iter__pod2.json").read_text())
    assert st["n_devices"] == 512 and st["collectives"]["collective-permute"]["count"] == 12
