"""Dry-run: the cost of every (architecture x shape x mesh) cell on one rank
of the production mesh, and its roofline terms in H100 figures, with no
card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_1_5b --shape train_4k \\
        --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all     # results/dryrun_torch/

The port of ``repro/launch/dryrun.py``, with its CLI and, where they mean
the same thing, its record keys; it writes under ``results/dryrun_torch``
by default, so the reference's artifacts are never overwritten.  The
reference lowers and compiles each cell with XLA for 256 (512) fake
devices and reads XLA's cost analysis and the compiled HLO's collectives;
the port has no HLO (no ``parse_collectives``, no HLO regexes, no memory
analysis).  It traces the cell's step on the ``meta`` device for rank 0 of
the mesh instead, as the port would run it there:

* a train cell is ``runtime/sharded.py``'s step: the rank's parameter
  blocks gathered, the forward and backward on its batch shard, the ZeRO-1
  update; a prefill or decode cell is the serving step on the rank's batch
  shard with the gathered parameters (the port shards no serving: the
  caches are the shard's whole);
* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products);
* bytes: every aten op's operands and results, once each (a
  ``TorchDispatchMode``; views move nothing): the unfused count, which is
  what the port's eager kernels move, and the counterpart of XLA CPU's
  "bytes accessed";
* collectives: ``core.dist.MeshComm``'s recording mode, ``(op, bytes,
  group size)`` per call, link bytes by the ring model (all-gather and
  reduce-scatter ``(g-1)/g`` of the full tensor, all-reduce twice that,
  a collective-permute its slab);
* the peak of live meta storage during the trace, plus the step's inputs.

Depth: as the reference does, the cost comes from the 1- and 2-period
probes of ``model.probe_config`` (no remat, the flash block coarsened to
``seq/4``), extrapolated to the full depth (affine in the periods; for
RWKV bilinear in depth and sequence); the whole step at full depth is also
traced once, for its peak memory and its cost with remat.  ``analyze``
turns the cost into the three roofline terms with H100 SXM data-sheet
figures (NVIDIA H100 Tensor Core GPU data sheet, SXM5, 700 W):

* ``PEAK_FLOPS`` 989 TFLOP/s, dense bf16 on the tensor cores (the stencil
  cells use ``core.perfmodel``'s 67 TFLOP/s f32 off the tensor cores: its
  kernels issue no tensor-core instruction);
* ``HBM_BW`` 3.35 TB/s, HBM3;
* ``NVLINK_BW`` 450 GB/s each way to the other cards of an 8-card node;
* ``NODE_LINK_BW`` 50 GB/s a card for a group that spans nodes (one NDR
  400 Gb/s InfiniBand link per card).

A collective moves at the NVLink rate when its group (rank 0's) lies in one
node of 8 consecutive ranks, else at the node-link rate.  Stencil cells
(``cs1_paper``, ``joule_600``, ``joule_370``) come from the port's op counts
(``core/perfmodel.py``: 44 flops and 42 words a meshpoint an iteration) for
one rank's block, the halo slabs of the iteration's two SpMVs and its three
AllReduces; no AllReduce latency is modelled (none is measured).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.stencil_cs1 import STENCIL_CELLS
from repro_torch.core import perfmodel
from repro_torch.core.dist import MeshComm
from repro_torch.launch import roofline_model
from repro_torch.launch.mesh import RankMesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.models.param import (
    block_slices, map_tree, rule_overrides, split_batch, tree_leaves,
)
from repro_torch.models.transformer import ArchConfig, DecoderLM
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.sharded import ShardedLayout, make_sharded_train_step

#: dense bf16 tensor-core rate, flop/s (H100 SXM data sheet)
PEAK_FLOPS = 989e12
#: HBM3 rate, bytes/s (H100 SXM data sheet)
HBM_BW = 3.35e12
#: NVLink, bytes/s each way, among the 8 cards of a node (H100 SXM data sheet)
NVLINK_BW = 450e9
#: bytes/s a card across nodes: one NDR 400 Gb/s InfiniBand link per card
NODE_LINK_BW = 50e9
CARDS_PER_NODE = 8

LM_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
STENCILS = ("cs1_paper", "joule_600", "joule_370")
#: the fused BiCGStab iteration's AllReduces, in f32 values each:
#: <r0,s>; <q,y> and <y,y>; <r0,r'> and <r',r'>
STENCIL_ALLREDUCE_VALUES = (1, 2, 2)


# ---------------------------------------------------------------------------
# Tracing on the meta device
# ---------------------------------------------------------------------------

_NO_BYTES = {"empty", "empty_strided", "empty_like", "detach", "lift_fresh"}


class ByteCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Sums every aten op's operand and result bytes (views and fresh
    allocations move none) and follows the live storage of the results:
    ``bytes``, ``ops``, ``peak_live`` (bytes)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak_live = 0
        self._sizes: dict[int, int] = {}
        self._refs: dict[int, int] = {}

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= self._sizes.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak_live = max(self.peak_live, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _NO_BYTES:
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
            self.ops += 1
        for t in outs:
            self._track(t)
        return out


def _blocks(defs, specs: dict, mesh, dtype=None) -> dict:
    """Meta tensors of this rank's blocks of every leaf."""
    return map_tree(lambda k, d: torch.empty(
        [s.stop - s.start for s in block_slices(d.shape, specs[k], mesh)],
        dtype=dtype or d.dtype, device="meta"), defs, with_path=True)


def _meta_caches(cfg: ArchConfig, batch: int, max_len: int, length: int) -> list[dict]:
    """``model.init_caches``'s per-layer caches as meta tensors, each
    attention cache holding ``length`` positions."""
    enc_len = cfg.enc_len_decode if cfg.enc_dec else 0
    out = []
    for spec in cfg.layer_specs():
        c = map_tree(lambda d: torch.zeros(d.shape, dtype=d.dtype, device="meta"),
                     transformer._layer_cache_defs(cfg, spec, batch, max_len, enc_len))
        if "attn" in c:
            c["attn"].length = length
        out.append(c)
    return out


def _input_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def trace_cell(cfg: ArchConfig, shape: M.ShapeSpec, mesh: RankMesh) -> dict:
    """One step of ``cfg`` at ``shape`` traced on the meta device for
    ``mesh.rank``: FLOPs, bytes, ops, the recorded collectives and the peak
    of live storage (the step's inputs included)."""
    from torch.utils.flop_counter import FlopCounterMode

    log: list = []
    with rule_overrides(dict(cfg.rules)):
        layout = ShardedLayout(cfg, mesh, shape.global_batch, MeshComm(mesh, record=log))
        batch = layout.batch_shard(M.input_specs(cfg, shape))
        params = _blocks(layout.defs, layout.pspec, mesh)
        if shape.kind == "train":
            opt = AdamWState(_blocks(layout.defs, layout.zspec, mesh, torch.float32),
                             _blocks(layout.defs, layout.zspec, mesh, torch.float32),
                             torch.zeros((), dtype=torch.int32, device="meta"))
            inputs = (params, opt, batch)
            step = make_sharded_train_step(cfg, layout)
            run = lambda: step(params, opt, batch)
        else:
            caches = _meta_caches(cfg, shape.global_batch // layout.shards, shape.seq_len,
                                  shape.seq_len - 1 if shape.kind == "decode" else 0)
            inputs = (params, batch, caches)
            serve = (M.make_prefill_step(cfg, shape) if shape.kind == "prefill"
                     else M.make_serve_step(cfg))

            def run():
                model = DecoderLM.from_tree(cfg, layout.gather(params))
                with split_batch(layout.split()):
                    return serve(model, batch, caches)

        base = _input_bytes(inputs)
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc, ByteCounter() as bc:
            out = run()
            del out
        seconds = time.perf_counter() - t0
    coll = summarize_collectives(log, mesh)
    return dict(flops=int(fc.get_total_flops()), bytes=int(bc.bytes), ops=bc.ops,
                coll_bytes=coll["total_bytes"], coll_link_bytes=coll["total_link_bytes"],
                n_collectives=coll["n_collectives"], t_collective_s=coll["t_collective_s"],
                peak_live_bytes=base + bc.peak_live, input_bytes=base, trace_s=seconds,
                collectives=coll["by_op"])


def summarize_collectives(log: list[dict], mesh: RankMesh) -> dict:
    """The recorded collectives by op, their bytes and ring link bytes, and
    their time at each group's link rate: the NVLink rate when rank 0's
    group lies in one node of ``CARDS_PER_NODE`` consecutive ranks, else the
    node-link rate (an entry may name its ``nodes`` itself)."""
    agg: dict = {}
    t = 0.0
    for e in log:
        a = agg.setdefault(e["op"], {"count": 0, "bytes": 0, "link_bytes": 0.0})
        a["count"] += 1
        a["bytes"] += e["bytes"]
        a["link_bytes"] += e["link_bytes"]
        nodes = e["nodes"] if "nodes" in e else _nodes_spanned(e["axes"], mesh)
        t += e["link_bytes"] / (NVLINK_BW if nodes == 1 else NODE_LINK_BW)
    return {"by_op": agg, "total_bytes": sum(e["bytes"] for e in log),
            "total_link_bytes": sum(e["link_bytes"] for e in log),
            "n_collectives": len(log), "t_collective_s": t}


def _nodes_spanned(axes, mesh: RankMesh) -> int:
    """Nodes spanned by rank 0's group over ``axes``."""
    ranks = [r for r in range(mesh.size)
             if all(c == 0 for a, c in RankMesh(mesh.axis_names, mesh.extents, r).coords.items()
                    if a not in axes)]
    return len({r // CARDS_PER_NODE for r in ranks})


COST_KEYS = ("flops", "bytes", "coll_bytes", "coll_link_bytes", "n_collectives",
             "t_collective_s")


def extrapolate(c1: dict, c2: dict, n_periods: int) -> dict:
    """total = probe1 + (P-1) * (probe2 - probe1): exact for a periodic stack."""
    return {k: c1[k] + (n_periods - 1) * (c2[k] - c1[k]) for k in COST_KEYS}


def bilinear(c1a: dict, c2a: dict, c1b: dict, c2b: dict, Ta: int, Tb: int, T: int,
             n_periods: int) -> dict:
    """RWKV's cost, affine in the sequence and in the depth: the reference's
    bilinear extrapolation from 1-/2-period probes at two lengths."""
    cost = {}
    for key in COST_KEYS:
        b_a, b_b = c2a[key] - c1a[key], c2b[key] - c1b[key]
        a_a, a_b = c1a[key] - b_a, c1b[key] - b_b
        b_T = b_a + (b_b - b_a) * (T - Ta) / (Tb - Ta)
        a_T = a_a + (a_b - a_a) * (T - Ta) / (Tb - Ta)
        cost[key] = a_T + n_periods * b_T
    return cost


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def lower_lm_cell(arch: str, shape_name: str, multi_pod: bool, cfg: ArchConfig | None = None,
                  *, mesh: RankMesh | None = None, shape: M.ShapeSpec | None = None) -> dict:
    """One LM cell's record on rank 0 of ``mesh`` (default: the production
    mesh): the probes' extrapolated cost, the whole step's trace, the
    roofline terms and ``roofline_model``'s estimates."""
    cfg = cfg or get_config(arch)
    shape = shape or M.SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(e) for e in mesh.extents), "kind": shape.kind}
    ok, reason = M.cell_is_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", skip_reason=reason)
        return rec
    n_dev = mesh.size
    rec["whole_trace"] = trace_cell(cfg, shape, mesh)
    has_rwkv = any(s.kind == "rwkv" for s in cfg.period)
    t0 = time.perf_counter()
    if has_rwkv and shape.kind != "decode":
        Ta, Tb = 2 * cfg.rwkv_chunk, 4 * cfg.rwkv_chunk

        def cv(k, T):
            sh = dataclasses.replace(shape, seq_len=T)
            return trace_cell(M.probe_config(cfg, k, T), sh, mesh)

        c1a, c2a, c1b, c2b = cv(1, Ta), cv(2, Ta), cv(1, Tb), cv(2, Tb)
        cost = bilinear(c1a, c2a, c1b, c2b, Ta, Tb, shape.seq_len, cfg.n_periods)
        rec["probe_mode"] = "bilinear_depth_x_seq"
        rec["probe1_cost"], rec["probe2_cost"] = c1a, c2b
    else:
        c1 = trace_cell(M.probe_config(cfg, 1, shape.seq_len), shape, mesh)
        c2 = trace_cell(M.probe_config(cfg, 2, shape.seq_len), shape, mesh)
        cost = extrapolate(c1, c2, cfg.n_periods)
        rec["probe_mode"] = "depth"
        rec["probe1_cost"], rec["probe2_cost"] = c1, c2
    rec["probe_trace_s"] = time.perf_counter() - t0

    n_act = M.n_active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_act * tokens
    rec.update(analyze(cost, n_dev, model_flops))
    rec.update(n_params=M.n_params(cfg), n_active_params=n_act, tokens_per_step=tokens)
    with rule_overrides(dict(cfg.rules)):
        est = roofline_model.lm_cell_memory_estimate(cfg, shape, mesh)
    rec.update(est)
    rec["t_memory_est_s"] = est["est_hbm_traffic_bytes"] / HBM_BW
    rec["t_bound_est_s"] = max(rec["t_compute_s"], rec["t_memory_est_s"],
                               rec["t_collective_s"])
    rec["dominant_est"] = max(("compute", rec["t_compute_s"]),
                              ("memory", rec["t_memory_est_s"]),
                              ("collective", rec["t_collective_s"]), key=lambda kv: kv[1])[0]
    rec["roofline_fraction_est"] = (model_flops / n_dev / PEAK_FLOPS) / max(
        rec["t_bound_est_s"], 1e-30)
    rec["status"] = "ok"
    return rec


def analyze(cost: dict, n_dev: int, model_flops: float, *, peak: float = PEAK_FLOPS) -> dict:
    """The three roofline terms of a per-rank cost, and the useful share."""
    t_comp = cost["flops"] / peak
    t_mem = cost["bytes"] / HBM_BW
    t_coll = cost["t_collective_s"]
    hlo_global = cost["flops"] * n_dev
    t_bound = max(t_comp, t_mem, t_coll)
    return {
        "n_devices": n_dev,
        "per_chip_flops": cost["flops"],
        "per_chip_bytes": cost["bytes"],
        "coll_bytes": cost["coll_bytes"],
        "coll_link_bytes": cost["coll_link_bytes"],
        "n_collectives": cost["n_collectives"],
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "t_bound_s": t_bound,
        "dominant": max(("compute", t_comp), ("memory", t_mem), ("collective", t_coll),
                        key=lambda kv: kv[1])[0],
        "model_flops_global": model_flops,
        "useful_flops_ratio": model_flops / hlo_global if hlo_global else 0.0,
        "roofline_fraction": (model_flops / n_dev / peak) / max(t_bound, 1e-30),
    }


# ---------------------------------------------------------------------------
# Stencil cells (no trace: the port's op counts)
# ---------------------------------------------------------------------------

def lower_stencil_cell(cell_name: str, multi_pod: bool, *, fused: bool = True,
                       overlap: bool = True, policy_name: str | None = None) -> dict:
    """One BiCGStab iteration on rank 0's block of the production mesh:
    ``perfmodel``'s flops and words a meshpoint, the halo slabs of two
    SpMVs (collective-permutes), three AllReduces."""
    from repro_torch.core import precision

    cell = STENCIL_CELLS[cell_name]
    policy = precision.get_policy(policy_name or cell.policy)
    itemsize = torch.empty((), dtype=policy.storage).element_size()
    pods = 2 if multi_pod else 1
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    X, Y, Z = cell.mesh_shape
    bx, by, bz = X // 16, Y // 16, Z // pods
    pts = bx * by * bz
    log = []
    comm = perfmodel.SOLVER_COMMS["bicgstab"]
    # rank 0's neighbours: +1 along model (rank 1, its node), +16 along data
    # and +256 along pod (other nodes); two slabs each way a split axis
    faces = [(by * bz, 1), (bx * bz, 2)] + ([(bx * by, 2)] if pods > 1 else [])
    for _ in range(comm.n_spmv):
        for face, nodes in faces:
            for _ in range(2):
                nb = face * itemsize
                log.append(dict(op="collective-permute", bytes=nb, group=2, link_bytes=nb,
                                nodes=nodes))
    n_red = comm.reductions_fused if fused else comm.reductions_separate
    values = STENCIL_ALLREDUCE_VALUES if fused else (1,) * n_red
    for v in values:
        nb = 4 * v
        log.append(dict(op="all-reduce", bytes=nb, group=n_dev,
                        link_bytes=2 * nb * (n_dev - 1) / n_dev, nodes=2))
    coll = summarize_collectives(log, mesh)
    flops = perfmodel.FLOPS_PER_PT * pts
    nbytes = perfmodel.WORDS_PER_PT * itemsize * pts + 2 * sum(
        e["bytes"] for e in log if e["op"] == "collective-permute")
    cost = dict(flops=flops, bytes=nbytes, coll_bytes=coll["total_bytes"],
                coll_link_bytes=coll["total_link_bytes"], n_collectives=coll["n_collectives"],
                t_collective_s=coll["t_collective_s"])
    npts = X * Y * Z
    rec = {"arch": f"stencil_{cell_name}", "shape": "bicgstab_iter",
           "mesh": _mesh_name(multi_pod), "kind": "solver", "fused_reductions": fused,
           "overlap_halo": overlap, "policy": policy.name}
    rec.update(analyze(cost, n_dev, 44.0 * npts, peak=perfmodel.PEAK_FLOPS))
    est = roofline_model.stencil_cell_memory_estimate(cell.mesh_shape, (16, 16, pods),
                                                      itemsize=itemsize)
    rec.update(collectives=coll["by_op"], meshpoints=npts,
               t_memory_est_s=est["est_hbm_traffic_bytes"] / HBM_BW,
               paper_iter_us_cs1=28.1 if cell_name == "cs1_paper" else None, **est)
    rec["status"] = "ok"
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_cells(cells, out_dir: str) -> list[dict]:
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for kind, name, shape, multi_pod in cells:
        tag = f"{name}__{shape}__{'pod2' if multi_pod else 'pod1'}"
        path = os.path.join(out_dir, tag + ".json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            if rec.get("status") in ("ok", "skipped"):
                print(f"[cached] {tag}: {rec.get('status')}")
                results.append(rec)
                continue
        print(f"[trace ] {tag} ...", flush=True)
        try:
            if kind == "lm":
                rec = lower_lm_cell(name, shape, multi_pod)
            else:
                rec = lower_stencil_cell(name, multi_pod)
        except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
            rec = {"arch": name, "shape": shape, "mesh": _mesh_name(multi_pod),
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        status = rec.get("status")
        extra = ""
        if status == "ok":
            extra = (f" dominant={rec['dominant']} t_bound={rec['t_bound_s']:.3e}s"
                     f" trace={rec.get('probe_trace_s', 0):.0f}s")
        print(f"[done  ] {tag}: {status}{extra}", flush=True)
        results.append(rec)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", help="arch id or stencil cell (stencil:<name>)")
    ap.add_argument("--shape", help="shape name (LM archs)", default=None)
    ap.add_argument("--mesh", choices=["single", "pod", "both"], default="both")
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--stencil-only", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    pods = {"single": [False], "pod": [True], "both": [False, True]}[args.mesh]
    cells: list = []
    if args.all or args.stencil_only:
        if not args.stencil_only:
            for arch in ARCH_IDS:
                for shape in LM_SHAPES:
                    for mp in pods:
                        cells.append(("lm", arch, shape, mp))
        for cell in STENCILS:
            for mp in pods:
                cells.append(("stencil", cell, "bicgstab_iter", mp))
    elif args.arch and args.arch.startswith("stencil:"):
        for mp in pods:
            cells.append(("stencil", args.arch.split(":", 1)[1], "bicgstab_iter", mp))
    elif args.arch:
        shapes = [args.shape] if args.shape else LM_SHAPES
        for shape in shapes:
            for mp in pods:
                cells.append(("lm", args.arch, shape, mp))
    else:
        ap.error("pass --arch or --all")

    results = run_cells(cells, args.out)
    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum(r.get("status") == "skipped" for r in results)
    n_err = sum(r.get("status") == "error" for r in results)
    print(f"\n=== dry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)} cells ===")
    if n_err:
        for r in results:
            if r.get("status") == "error":
                print(" ERROR:", r["arch"], r["shape"], r["mesh"], "-", r["error"])
        raise SystemExit(1)


if __name__ == "__main__":
    main()
