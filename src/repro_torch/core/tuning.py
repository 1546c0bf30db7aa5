"""Persistent tuning cache for the Hopper stencil kernel: sweep a cell once,
keep the winner, look it up when an operator is built.

Counterpart of ``repro/core/tuning.py``, with its contract: with no valid
entry the kernel runs the deterministic default (the launch plan it had
before the cache existed), and any valid config gives the same bits, since
each output is a canonical-order sum over the offsets whatever the plan.

* :class:`KernelConfig`: one point of the kernel's space, the x segment
  (``seg_len`` planes), the RHS chunk (``chunk`` right-hand sides a block
  carries, for the ``nrhs`` it was chosen at) and ``fuse_ring`` (the
  overlap schedule's boundary ring folded into one pass,
  ``kernels/stencil_nd/fused.py:fused_ring_apply``).  It records the
  (ty, tz) tile, which is not swept: ``stencil_nd.cu`` is compiled for one
  tile and refuses any other.
* :class:`TuningCache`: a JSON map from ``"{device}/{spec}/{dtype}/{XxYxZ}"``
  to the winner and the sweep that chose it, in
  ``results/tuning_cache_torch.json``; ``REPRO_TORCH_TUNING_CACHE`` points
  it elsewhere or (``off``) disables it.  The JAX package's file and
  variable are never read: its entries are TPU tiles.
* :func:`lookup_config`: ``(config, source)``, source ``cache``,
  ``default`` or ``stale`` (an entry the kernel cannot run, which falls back
  to the default before any launch).
* :func:`candidate_configs`, :func:`measure_config`, :func:`autotune_cell`,
  :func:`ensure_tuned`: the sweep that ``launch.solve --autotune`` runs for
  its own cell, on the run's own fabric: the overlapped SpMV a candidate
  is timed as is the one the solve runs.  ``fuse_ring`` is swept only where
  the fabric has a boundary ring; on one rank both forms run one pad and
  one kernel per SpMV.  ``measure_config`` times the kernel with CUDA
  events and refuses a CPU tensor, where only the plain version would run.
  The sweep checks every candidate's output against the default's bit for
  bit before it may win.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import perfmodel
from repro_torch.core.halo import FabricAxes
from repro_torch.core.stencil import StencilSpec
from repro_torch.device import device_name
from repro_torch.kernels.stencil_nd.kernel import FAMILY, config_error as _kernel_error
from repro_torch.kernels.stencil_nd.kernel import launch_plan
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

#: default persistence path, relative to the working directory
DEFAULT_CACHE_PATH = os.path.join("results", "tuning_cache_torch.json")
#: the variable that overrides (a path) or disables (``off``) the cache
ENV_VAR = "REPRO_TORCH_TUNING_CACHE"
_DISABLED = ("", "0", "off", "none", "false", "no")
CACHE_FORMAT = "repro_torch.tuning_cache.v1"

#: x segments the sweep tries besides the whole block and the default
SEG_LENS = (8, 16, 32, 64)
#: the one-rank fabric: no split axis, so no boundary ring
ONE_RANK = FabricAxes()
#: a synthetic fabric with x and y split, whose overlap schedule patches four
#: ring slabs: where the fused and split ring forms are held to each other
RING_FABRIC = FabricAxes(nx=2, ny=2)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty(0, dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point of the stencil kernel's tuning space (see module doc).

    ``chunk`` was chosen for ``nrhs`` right-hand sides: a launch of another
    batch keeps the default chunk for its own batch (``launch_plan``), so
    an entry swept at one batch never slows another."""

    seg_len: int
    chunk: int
    tile: tuple[int, int]
    fuse_ring: bool = False
    nrhs: int = 1

    def to_json(self) -> dict:
        return {"seg_len": self.seg_len, "chunk": self.chunk, "tile": list(self.tile),
                "fuse_ring": self.fuse_ring, "nrhs": self.nrhs}

    @classmethod
    def from_json(cls, d: dict) -> "KernelConfig":
        return cls(seg_len=int(d["seg_len"]), chunk=int(d["chunk"]),
                   tile=tuple(int(t) for t in d["tile"]),
                   fuse_ring=bool(d.get("fuse_ring", False)), nrhs=int(d.get("nrhs", 1)))


def cache_key(device, spec: StencilSpec, dtype, shape: tuple[int, ...]) -> str:
    """``NVIDIA H100 80GB HBM3/star7/bfloat16/608x608x1536``: the name of
    ``device``'s card (``cpu`` on the host), the spec, the storage dtype and
    the local block."""
    dims = "x".join(str(int(s)) for s in shape)
    return f"{device_name(device)}/{spec.name}/{dtype_name(dtype)}/{dims}"


def config_error(config: KernelConfig, spec: StencilSpec, dtype,
                 shape: tuple[int, int, int]) -> str | None:
    """Why the kernel cannot run ``config`` on a ``shape`` block, or None."""
    if (spec.n_offsets, spec.radius) not in FAMILY:
        return f"no stencil kernel for {spec.name}"
    return _kernel_error(config, tuple(shape), spec.n_offsets, spec.radius, _itemsize(dtype))


def default_config(spec: StencilSpec, dtype, shape: tuple[int, int, int],
                   nb: int = 1) -> KernelConfig:
    """The deterministic default: exactly the plan ``launch_plan`` makes
    without a config for ``nb`` right-hand sides, and the split ring."""
    plan = launch_plan(tuple(shape), nb, spec.n_offsets, spec.radius, _itemsize(dtype))
    return KernelConfig(seg_len=plan.seg_len, chunk=plan.chunk, tile=(plan.ty, plan.tz),
                        nrhs=nb)


# ---------------------------------------------------------------------------
# The persistent cache
# ---------------------------------------------------------------------------

class TuningCache:
    """A {cache_key -> sweep record} map persisted as one JSON file; each
    entry holds the winning ``config`` and the measurements that chose it."""

    def __init__(self, path: str | None, entries: dict | None = None):
        self.path = path
        self.entries: dict[str, dict] = dict(entries or {})

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        """Load from ``path``; a missing or unreadable file is an empty
        cache (deterministic defaults), never an error."""
        try:
            with open(path) as f:
                raw = json.load(f)
            entries = raw.get("entries", {}) if isinstance(raw, dict) else {}
        except (OSError, ValueError):
            entries = {}
        return cls(path, entries)

    def save(self, path: str | None = None) -> str:
        path = path or self.path or DEFAULT_CACHE_PATH
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "format": CACHE_FORMAT,
            "generated_by": "repro_torch.core.tuning",
            "hbm_bytes_per_s": perfmodel.HBM_BW,
            "entries": {k: self.entries[k] for k in sorted(self.entries)},
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        self.path = path
        return path

    def get(self, key: str) -> KernelConfig | None:
        entry = self.entries.get(key)
        if entry is None:
            return None
        try:
            return KernelConfig.from_json(entry["config"])
        except (KeyError, TypeError, ValueError):
            return None

    def put(self, key: str, config: KernelConfig, record: dict | None = None) -> None:
        self.entries[key] = {"config": config.to_json(), **(record or {})}

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def __len__(self) -> int:
        return len(self.entries)


def resolve_cache_path() -> str | None:
    """The active cache path: ``REPRO_TORCH_TUNING_CACHE`` (a path, or one
    of ``0/off/none`` to disable lookup), else the default."""
    env = os.environ.get(ENV_VAR)
    if env is None:
        return DEFAULT_CACHE_PATH
    if env.strip().lower() in _DISABLED:
        return None
    return env


# (path -> (mtime, cache)) memo; a saved cache bumps the mtime and is re-read
_LOADED: dict[str, tuple[float, TuningCache]] = {}


def get_cache(path: str | None = None) -> TuningCache | None:
    """The active :class:`TuningCache`, or None when lookup is disabled."""
    path = path if path is not None else resolve_cache_path()
    if path is None:
        return None
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = -1.0
    hit = _LOADED.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    cache = TuningCache.load(path)
    _LOADED[path] = (mtime, cache)
    return cache


def lookup_config(spec: StencilSpec, dtype, shape: tuple[int, ...], *, device,
                  cache: TuningCache | None = None) -> tuple[KernelConfig, str]:
    """``(config, source)`` for a block on ``device``.

    ``shape`` may carry a leading batch axis; only the trailing mesh dims
    key the lookup, so a cell tuned at ``(bx, by, Z)`` serves every batch
    size (the default is the plan for the batch given).  ``source`` is
    ``cache`` for a valid entry, ``default`` when the cache is disabled,
    missing or has no entry, and ``stale`` when an entry names a config the
    kernel cannot run on this block (the default is used, with a warning).
    """
    shape = tuple(int(s) for s in shape)
    mesh, nb = shape[-3:], math.prod(shape[:-3])
    cache = cache if cache is not None else get_cache()
    key = cache_key(device, spec, dtype, mesh)
    if cache is not None:
        tuned = cache.get(key)
        if tuned is not None:
            problem = config_error(tuned, spec, dtype, mesh)
            if problem is None:
                obs_metrics.counter("tuning.lookup.cache").inc()
                return tuned, "cache"
            warnings.warn(f"tuning-cache entry {key!r} is stale ({problem}); using the "
                          f"default config; re-sweep with launch.solve --autotune",
                          stacklevel=2)
            obs_metrics.counter("tuning.lookup.stale").inc()
            return default_config(spec, dtype, mesh, nb), "stale"
    obs_metrics.counter("tuning.lookup.default").inc()
    return default_config(spec, dtype, mesh, nb), "default"


def cached_config(spec: StencilSpec, dtype, shape: tuple[int, ...], *,
                  device) -> KernelConfig | None:
    """The config an operator hands its stencil kernel: the cache's entry
    when :func:`lookup_config` finds a valid one, else None (the kernel's
    default plan, for whatever batch it is given).  A block the kernel has
    no instance for (not 3-D, not bf16 or f32) is not looked up."""
    if len(shape) != 3 or _itemsize(dtype) not in (2, 4):
        return None
    config, source = lookup_config(spec, dtype, shape, device=device)
    return config if source == "cache" else None


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def candidate_configs(spec: StencilSpec, dtype, shape: tuple[int, int, int],
                      nb: int = 1, fabric: FabricAxes = ONE_RANK) -> list[KernelConfig]:
    """The sweep's candidates for one cell, deduplicated and valid, the
    default first: x segments of 8, 16, 32, 64 and bx planes (and the
    default's), RHS chunks of 1 and the family maximum (the kernel's two
    instances) when the cell is batched, and, where ``fabric`` has a
    boundary ring, the ring split and fused."""
    from repro_torch.core.comm import boundary_regions

    base = default_config(spec, dtype, shape, nb)
    segs = sorted({*SEG_LENS, shape[0], base.seg_len})
    chunks = sorted({1, FAMILY[(spec.n_offsets, spec.radius)][1]}) if nb > 1 else [base.chunk]
    # the fold changes the work only where the overlap schedule patches a ring
    fuses = (False, True) if boundary_regions(tuple(shape), fabric, spec.radius) else (False,)
    cands = [base]
    for seg in segs:
        for chunk in chunks:
            for fuse in fuses:
                c = KernelConfig(seg_len=seg, chunk=chunk, tile=base.tile, fuse_ring=fuse,
                                 nrhs=nb)
                if c != base and config_error(c, spec, dtype, shape) is None:
                    cands.append(c)
    return cands


class CellProblem(NamedTuple):
    """A sweep's inputs: the coefficient fields, the iterate, the fabric
    and the iterate's synthetic exchange on it."""
    cf_list: list[torch.Tensor]
    v: torch.Tensor
    fabric: FabricAxes
    exchange: object


def synthetic_exchange(v: torch.Tensor, spec: StencilSpec, fabric: FabricAxes, *,
                       generator: torch.Generator | None = None):
    """A stand-in for a finished depth-r halo exchange, with no collective.

    The layout of a real one: the padded interior is ``v`` bit for bit, the
    halo slabs of every split fabric axis carry values (random, standing in
    for a neighbor's faces), and the unsplit axes' halos stay zero (the
    global Dirichlet boundary).  The fused-versus-split identity rests on
    that layout.  ``v`` may carry a leading batch axis."""
    from repro_torch.core import comm

    r = spec.radius
    nb = v.ndim - 3
    gen = generator or torch.Generator(device=v.device).manual_seed(2)
    vp = F.pad(v, (r, r) * 3)
    for axis, name, n in fabric.split_info(3):
        if name is None or n == 1:
            continue
        for side in (slice(0, r), slice(vp.shape[nb + axis] - r, None)):
            reg = (slice(None),) * nb + tuple(side if i == axis else slice(None)
                                              for i in range(3))
            vp[reg] = torch.randn(vp[reg].shape, generator=gen,
                                  device=v.device).to(vp.dtype)
    return comm.HaloExchange(v, fabric, r, spec.needs_corners, nb, filled=vp)


def cell_problem(spec: StencilSpec, dtype, shape: tuple[int, int, int], *, nrhs: int = 1,
                 device="cuda", fabric: FabricAxes = ONE_RANK) -> CellProblem:
    """Seeded inputs for timing one cell on ``fabric``, drawn on
    ``device``: each field uniform in +-1/n_offsets, the iterate standard
    normal."""
    gen = torch.Generator(device=device).manual_seed(0)
    scale = 2.0 / spec.n_offsets
    cf_list = [((torch.rand(shape, generator=gen, device=device) - 0.5) * scale).to(dtype)
               for _ in spec.names]
    vshape = (nrhs,) + tuple(shape) if nrhs > 1 else tuple(shape)
    v = torch.randn(vshape, generator=gen, device=device).to(dtype)
    return CellProblem(cf_list, v, fabric, synthetic_exchange(v, spec, fabric, generator=gen))


def config_apply(problem: CellProblem, spec: StencilSpec, config: KernelConfig) -> torch.Tensor:
    """One overlapped SpMV of the cell under ``config``, as the solve runs
    it on the problem's fabric: with ``fuse_ring`` one pass over the
    exchanged block; without, the kernel on the zero-padded block and a
    patch of each ring slab (none on one rank).  The accumulation is the
    storage dtype, as every policy runs the kernel."""
    from repro_torch.kernels.stencil_nd.fused import fused_ring_apply
    from repro_torch.kernels.stencil_nd.ops import _kernel, ring_patch_apply

    cf_list, v, fabric, exchange = problem
    acc = v.dtype
    if config.fuse_ring:
        return fused_ring_apply(exchange, cf_list, spec, config, accum_dtype=acc)
    r = spec.radius
    u = _kernel(exchange.n_batch)(F.pad(v, (r, r) * 3), cf_list, spec.offsets, radius=r,
                                  accum_dtype=acc, config=config)
    return ring_patch_apply(exchange, cf_list, spec, u, fabric, accum_dtype=acc,
                            config=config)


def spmv_bytes(spec: StencilSpec, dtype, shape: tuple[int, int, int], nrhs: int = 1) -> int:
    """Device-memory bytes one SpMV must move: each coefficient field read
    once (shared by the right-hand sides), each RHS's v read and u written
    once."""
    return (spec.n_offsets + 2 * nrhs) * math.prod(shape) * _itemsize(dtype)


def measure_config(spec: StencilSpec, dtype, shape: tuple[int, int, int],
                   config: KernelConfig, *, nrhs: int = 1, repeats: int = 20,
                   problem: CellProblem | None = None, device="cuda") -> float:
    """Mean seconds of one :func:`config_apply` on the card: 3 warm-up
    launches, then ``repeats`` between two CUDA events.

    Raises on a CPU device: there only the plain version runs, and its time
    says nothing about a launch plan."""
    dev = torch.device(device) if problem is None else problem.v.device
    if dev.type != "cuda":
        raise ValueError(f"measure_config times the CUDA kernel with CUDA events; on {dev} "
                         f"only the plain version runs, which measures no launch plan")
    if problem is None:
        problem = cell_problem(spec, dtype, shape, nrhs=nrhs, device=dev)
    for _ in range(3):
        config_apply(problem, spec, config)
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        config_apply(problem, spec, config)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats / 1e3


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _card(device) -> str | None:
    """``name, power.limit`` of ``device``'s card from ``nvidia-smi``."""
    from repro_torch.obs.manifest import nvidia_smi

    dev = torch.device(device)
    smi = nvidia_smi() if dev.type == "cuda" else None
    return smi[dev.index or 0] if smi else None


def autotune_cell(spec: StencilSpec, dtype, shape: tuple[int, int, int], *, nrhs: int = 1,
                  fabric: FabricAxes = ONE_RANK, cache: TuningCache | None = None,
                  force: bool = False, repeats: int = 20, device="cuda",
                  save: bool = True) -> dict:
    """Sweep one {card x spec x dtype x block} cell and keep the winner.

    A valid cached entry swept at this ``nrhs`` short-circuits the sweep
    (``cache_hit`` True) unless ``force``; an entry swept at another batch
    is swept again and replaced.  Otherwise every candidate is timed
    (:func:`measure_config`) on one set of inputs on ``fabric`` (the run's
    own) and its output held to the default's bit for bit (a config that
    changed a bit raises: no plan may change a sum); the record names the
    card and its power limit and gives each candidate's share of the bytes
    bound (:func:`spmv_bytes` at ``perfmodel.HBM_BW``).  ``nrhs`` sweeps a
    batched cell (the RHS chunk axis); the key is the block's, whatever the
    batch.
    """
    cache = cache if cache is not None else get_cache()
    if cache is None:
        cache = TuningCache(resolve_cache_path() or DEFAULT_CACHE_PATH)
    shape = tuple(int(s) for s in shape)
    key = cache_key(device, spec, dtype, shape)
    cached = cache.get(key)
    if (cached is not None and not force and cached.nrhs == nrhs
            and config_error(cached, spec, dtype, shape) is None):
        obs_metrics.counter("tuning.sweep.cache_hit").inc()
        rec = dict(cache.entries[key])
        rec.update(key=key, cache_hit=True)
        return rec

    obs_metrics.counter("tuning.sweep.runs").inc()
    cands = candidate_configs(spec, dtype, shape, nb=nrhs, fabric=fabric)
    problem = cell_problem(spec, dtype, shape, nrhs=nrhs, device=device, fabric=fabric)
    nbytes = spmv_bytes(spec, dtype, shape, nrhs)
    bound_s = nbytes / perfmodel.HBM_BW
    swept, want = [], None
    with obs_trace.span("tuning.autotune_cell", key=key, n_candidates=len(cands)):
        for cfg in cands:
            t = measure_config(spec, dtype, shape, cfg, nrhs=nrhs, repeats=repeats,
                               problem=problem)
            u = config_apply(problem, spec, cfg)
            if want is None:
                want = u
            elif not _same_bits(u, want):
                raise RuntimeError(f"stencil config {cfg} gave other bits than the default "
                                   f"{cands[0]} on {key}; a launch plan must not change a sum")
            del u
            swept.append({"config": cfg.to_json(), "seconds": t, "bound_share": bound_s / t,
                          "bitwise_default": True})
    del problem, want
    default_s = swept[0]["seconds"]
    best = min(swept, key=lambda s: s["seconds"])
    record = {
        "key": key, "cache_hit": False, "card": _card(device),
        "shape": list(shape), "nrhs": nrhs, "fabric": [fabric.nx, fabric.ny, fabric.nz],
        "spec": spec.name, "dtype": dtype_name(dtype),
        "default_config": cands[0].to_json(),
        "default_seconds": default_s,
        "best_seconds": best["seconds"],
        "speedup_vs_default": default_s / best["seconds"],
        "spmv_bytes": nbytes, "bound_s": bound_s,
        "bound_share_default": bound_s / default_s,
        "bound_share_tuned": best["bound_share"],
        "n_candidates": len(swept),
        "swept": swept,
    }
    cache.put(key, KernelConfig.from_json(best["config"]), record)
    if save:
        cache.save()
    obs_metrics.event("autotune_sweep", key=key, best_seconds=best["seconds"],
                      speedup_vs_default=record["speedup_vs_default"],
                      bound_share_tuned=best["bound_share"])
    rec = dict(cache.entries[key])
    rec.update(key=key, cache_hit=False)
    return rec


#: ``launch.solve --autotune``'s entry, the JAX package's name: sweep the
#: cell only when no valid cache entry exists, then return the entry
ensure_tuned = autotune_cell
