#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: builds the kernels,
holds each against its plain PyTorch version, and drives the main path.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a GPU

Phases (one line of output each, JSON where it carries numbers):

1. the card's name and power limit (``nvidia-smi``), then the kernel build
   (``nvcc`` per source, into ``build/repro_torch_kernels/``) and its seconds;
2. every kernel against its plain version on the card, at 256x256x256,
   at the default cell's 48x48x32 and at the ragged 37x29x17, in f32 and
   bf16 (the stencil for star7, box27 and star25), then at the main path's
   own shape, 608x608x1536 in bf16 with bf16 stencil accumulation: vector
   outputs must be bitwise equal, dot partials within
   log2(n) x eps_f32 x sum|a_i b_i| (both sides sum the same exact f32
   products; only the order differs).  Each kernel's time on those
   paper-mesh inputs (CUDA events, warmed up, mean of 20 launches) goes
   beside its plain version's time, a library call's where one computes the
   same function, and its bound at 3.35 TB/s;
3. the CLI's default problem (48x48x32 convdiff star7, f32, tol 1e-6)
   through ``--backend fused`` for seeds 0-4: each must converge to a true
   relative residual below 1e-5, with the kernels' launch counts, and its
   iteration count must stay within 1 of the ``spmd`` backend's on the median
   seed and within 2 on every seed.  The same solves with the fused path's
   dots summed in the spmd backend's order (``Policy.dot``) must give the
   spmd solve bit for bit, iteration count included: the two paths differ
   only in the dots' summation order, which alone moves a count by up to 2;
4. the paper's mesh (``cs1_paper``, 608x608x1536, star7 convdiff,
   ``bf16_mixed``) through ``--backend fused`` for 30 iterations at tol 0:
   ms/iter, GB/s against the bytes an iteration must move, finite residuals
   below 1, and launch counts of exactly 2 stencil + 1 of each fused pass
   per iteration plus 2 dot_mixed at setup.

``--profile`` adds a torch.profiler trace of a few paper-mesh iterations:
device time by kernel and the card's idle share.

It exits non-zero, without the last line, when any phase fails, when no CUDA
device is present, or when the package is missing beside it.  The full
record goes to ``--out`` (default ``build/chip_smoke.json``).
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores, NVIDIA data sheet
EPS_F32 = 2.0 ** -23
PAPER_MESH = (608, 608, 1536)
DEFAULT_MESH = (48, 48, 32)  # the CLI's default cell (phase 3)
CHECK_SHAPES = [(256, 256, 256), DEFAULT_MESH, (37, 29, 17)]
MAIN_ITERS = 30
PHASE3_SEEDS = 5
PROFILE_ITERS = 5

KERNELS = {   # name -> (CUDA source, the TPU kernel it replaces)
    "stencil_nd": ("src/repro_torch/kernels/csrc/stencil_nd.cu",
                   "src/repro/kernels/stencil_nd/kernel.py:120"),
    "update_q_dots": ("src/repro_torch/kernels/csrc/fused_iter.cu",
                      "src/repro/kernels/fused_iter/kernel.py:74"),
    "update_xr_dots": ("src/repro_torch/kernels/csrc/fused_iter.cu",
                       "src/repro/kernels/fused_iter/kernel.py:124"),
    "update_p": ("src/repro_torch/kernels/csrc/fused_iter.cu",
                 "src/repro/kernels/fused_iter/kernel.py:168"),
    "dot_mixed": ("src/repro_torch/kernels/csrc/fused_iter.cu",
                  "src/repro/kernels/fused_iter/kernel.py:203"),
}

failures: list[str] = []
err = {k: 0.0 for k in KERNELS}        # max |kernel - plain| over every output checked
dot_rel = {k: 0.0 for k in KERNELS}    # max |dot diff| / sum |a_i b_i|
dot_signal: dict[str, float] = {}   # min |plain dot| / tolerance, per kernel with dots


def emit(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)
        emit(f"FAIL: {what}")


def cuda_ms(torch, fn, n: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``n`` launches, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    """The least time the card could take: bytes over 3.35 TB/s or flops
    over the f32 rate, whichever is larger (ms, and which one)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def dot_tol(n: int) -> float:
    """The allowed |kernel dot - plain dot| as a share of sum|a_i b_i|.

    Both sides sum the same n exact f32 products in f32, in different
    orders (grid-stride, block tree and a fixed-order pass against torch's
    reduction), so log2(n) f32 epsilons of sum|a_i b_i| covers the
    difference with room.  It sits well below the size of a cross dot of
    independent random vectors, about 1.6 / sqrt(n) of sum|a_i b_i|, so a
    kernel that returns 0 or drops part of its sum fails.
    """
    return math.log2(n) * EPS_F32


def vec_eq(name, got, want, label) -> None:
    err[name] = max(err[name], float((got.float() - want.float()).abs().max()))
    check(got.equal(want), f"{name} {label}: vector output not bitwise equal to its plain version")


def dot_close(name, got, want, a, b, label) -> None:
    scale = float((a.float() * b.float()).abs().sum())
    tol = dot_tol(a.numel()) * scale
    diff = abs(float(got) - float(want))
    err[name] = max(err[name], diff)
    dot_rel[name] = max(dot_rel[name], diff / scale)
    dot_signal[name] = min(dot_signal.get(name, math.inf), abs(float(want)) / tol)
    check(diff <= tol, f"{name} {label}: dot {float(got)!r} vs plain {float(want)!r} "
                       f"(|diff| {diff:.3e} > {tol:.3e})")


def check_fused_iter(torch, a, o, b, v, label) -> None:
    """K2-K5 against their plain versions on vectors ``v`` and 0-d f32 scalars."""
    from repro_torch.kernels.fused_iter import kernel as fk
    from repro_torch.kernels.fused_iter import ref as fref

    got, want = fk.update_q_dots(a, v[0], v[1], v[2]), fref.update_q_dots_ref(a, v[0], v[1], v[2])
    vec_eq("update_q_dots", got[0], want[0], label)
    dot_close("update_q_dots", got[1], want[1], got[0], v[2], label + " <q,y>")
    dot_close("update_q_dots", got[2], want[2], v[2], v[2], label + " <y,y>")
    # the fused loop's SpMV input must be the kernel's q, bit for bit
    vec_eq("update_q_dots", got[0], v[0] - a.to(v[0].dtype) * v[1], label + " q_in")
    del got, want
    got, want = fk.update_xr_dots(a, o, *v), fref.update_xr_dots_ref(a, o, *v)
    vec_eq("update_xr_dots", got[0], want[0], label + " x")
    vec_eq("update_xr_dots", got[1], want[1], label + " r")
    dot_close("update_xr_dots", got[2], want[2], v[4], got[1], label + " <r0,r>")
    dot_close("update_xr_dots", got[3], want[3], got[1], got[1], label + " <r,r>")
    del got, want
    vec_eq("update_p", fk.update_p(b, o, v[0], v[1], v[2]),
           fref.update_p_ref(b, o, v[0], v[1], v[2]), label)
    dot_close("dot_mixed", fk.dot_mixed(v[0], v[1]), fref.dot_mixed_ref(v[0], v[1]),
              v[0], v[1], label)


def scalars(torch):
    dev = torch.device("cuda")
    return tuple(torch.tensor(x, device=dev) for x in (0.37, -1.3, 0.81))   # alpha, omega, beta


def check_kernels(torch) -> None:
    """Every kernel vs its plain version at CHECK_SHAPES."""
    from repro_torch.core import stencil
    from repro_torch.kernels.stencil_nd.kernel import stencil_nd
    from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = {n: stencil.get_spec(n) for n in ("star7", "box27", "star25")}
    for shape in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            rnd = lambda shp: torch.randn(shp, generator=gen, device=dev).to(dtype)
            label = f"{'x'.join(map(str, shape))} {str(dtype).split('.')[-1]}"
            for sname, spec in specs.items():
                r = spec.radius
                vp = rnd(tuple(s + 2 * r for s in shape))   # random halo: indexing is checked
                cfs = [rnd(shape) * 0.2 for _ in spec.offsets]
                accs = [torch.float32] if dtype == torch.float32 else [torch.bfloat16,
                                                                       torch.float32]
                for acc in accs:
                    got = stencil_nd(vp, cfs, spec.offsets, radius=r, accum_dtype=acc)
                    want = stencil_nd_padded_ref(vp, cfs, spec.offsets, radius=r,
                                                 accum_dtype=acc)
                    vec_eq("stencil_nd", got, want,
                           f"{sname} {label} accum {str(acc).split('.')[-1]}")
                del vp, cfs
            check_fused_iter(torch, *scalars(torch), [rnd(math.prod(shape)) for _ in range(5)],
                             label)
    torch.cuda.synchronize()


def check_and_time_paper_mesh(torch) -> dict:
    """Each kernel against its plain version at the main path's shape and
    dtype (608x608x1536 bf16, star7, bf16 accumulation), then the times of
    both on the same inputs, with bytes and flops of the work for the bound."""
    from repro_torch.core import stencil
    from repro_torch.kernels.fused_iter import kernel as fk
    from repro_torch.kernels.fused_iter import ref as fref
    from repro_torch.kernels.stencil_nd.kernel import stencil_nd
    from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref

    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    n = math.prod(PAPER_MESH)
    spec = stencil.STAR7
    vp = torch.randn(tuple(s + 2 for s in PAPER_MESH), generator=gen, device=dev).to(dt)
    cfs = [(0.1 * torch.randn(PAPER_MESH, generator=gen, device=dev)).to(dt)
           for _ in spec.offsets]
    v = [torch.randn(n, generator=gen, device=dev).to(dt) for _ in range(5)]
    a, o, b = scalars(torch)
    label = f"{'x'.join(map(str, PAPER_MESH))} bfloat16"

    stencil_kernel = lambda: stencil_nd(vp, cfs, spec.offsets, radius=1, accum_dtype=dt)
    stencil_plain = lambda: stencil_nd_padded_ref(vp, cfs, spec.offsets, radius=1,
                                                  accum_dtype=dt)
    vec_eq("stencil_nd", stencil_kernel(), stencil_plain(), f"star7 {label} accum bfloat16")
    check_fused_iter(torch, a, o, b, v, label)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    vec = nbytes(v[0])
    out = {}

    def rec(name, kern, plain, moved, flops, library=None):
        out[name] = dict(ms=cuda_ms(torch, kern), plain_ms=cuda_ms(torch, plain),
                         library_ms=None if library is None else cuda_ms(torch, library),
                         bytes=moved, flops=flops)
        out[name]["bound_ms"], out[name]["bound_by"] = bound(moved, flops)

    rec("stencil_nd", stencil_kernel, stencil_plain, nbytes(vp, *cfs) + vec,
        2 * spec.n_offsets * n)
    rec("update_q_dots", lambda: fk.update_q_dots(a, v[0], v[1], v[2]),
        lambda: fref.update_q_dots_ref(a, v[0], v[1], v[2]), 4 * vec, 6 * n)
    rec("update_xr_dots", lambda: fk.update_xr_dots(a, o, *v),
        lambda: fref.update_xr_dots_ref(a, o, *v), 7 * vec, 10 * n)
    rec("update_p", lambda: fk.update_p(b, o, v[0], v[1], v[2]),
        lambda: fref.update_p_ref(b, o, v[0], v[1], v[2]), 4 * vec, 4 * n)
    rec("dot_mixed", lambda: fk.dot_mixed(v[0], v[1]),
        lambda: fref.dot_mixed_ref(v[0], v[1]), 2 * vec, 2 * n,
        library=lambda: torch.dot(v[0], v[1]))
    del vp, cfs, v
    torch.cuda.empty_cache()
    # dot_mixed in f32 beside torch.dot on the same f32 inputs
    x, y = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
    f32 = dict(shape=list(PAPER_MESH), ms=cuda_ms(torch, lambda: fk.dot_mixed(x, y)),
               torch_dot_ms=cuda_ms(torch, lambda: torch.dot(x, y)))
    f32["bound_ms"], f32["bound_by"] = bound(nbytes(x, y), 2 * n)
    del x, y
    torch.cuda.empty_cache()
    return {"bf16": out, "dot_mixed_f32": f32}


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path through the CLI's entry point
# ---------------------------------------------------------------------------

def iteration_bytes(shape, itemsize: int, radius: int = 1, n_off: int = 6) -> int:
    """Bytes one fused BiCGStab iteration must move: each op's inputs read
    once and its outputs written once."""
    n = math.prod(shape)
    n_pad = math.prod(s + 2 * radius for s in shape)
    pad = n + n_pad                      # read v, write its zero-padded copy
    spmv = n_pad + n_off * n + n         # read the padded v and the fields, write u
    fused = (3 + 4 + 7 + 4 + 2) * n      # q_in, update_q_dots, update_xr_dots, update_p, dot_mixed
    return (2 * (pad + spmv) + fused) * itemsize


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes per compiled kernel, from ``-Xptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def run_cli(argv):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import solve

    reset_launch_counts()
    res = solve.main(argv)
    return res, launch_counts()


def expected_counts(iters: int) -> dict:
    return {"stencil_nd": 2 * iters, "update_q_dots": iters, "update_xr_dots": iters,
            "update_p": iters, "dot_mixed": iters + 2}


def with_spmd_dots(op):
    """The fused operator with every dot partial taken as the spmd backend
    takes it (``Policy.dot``): the kernels' vector outputs stay, only the
    dots' summation order changes."""
    import dataclasses

    from repro_torch.core.operator import FusedOps

    d, f = op.policy.dot, op.fused

    def update_q_dots(alpha, r, s, y):
        q = f.update_q_dots(alpha, r, s, y)[0]
        return q, d(q, y), d(y, y)

    def update_xr_dots(alpha, omega, x, p, q, y, r0):
        x, r = f.update_xr_dots(alpha, omega, x, p, q, y, r0)[:2]
        return x, r, d(r0, r), d(r, r)

    return dataclasses.replace(op, fused=FusedOps(
        dot_partial=d, update_q_dots=update_q_dots, update_xr_dots=update_xr_dots,
        update_p=f.update_p))


def dot_order_matched(torch, seed: int) -> dict:
    """The CLI's default f32 solve through spmd and through the fused kernels
    with spmd-order dots; the second must be the first bit for bit."""
    from repro_torch.core import precision, stencil
    from repro_torch.core.operator import make_operator
    from repro_torch.core.solvers import get_solver
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import solve

    _, cf, b = solve.manufactured_system(None, stencil.STAR7, DEFAULT_MESH, seed=seed,
                                         device=torch.device("cuda"))
    kw = dict(tol=1e-6, maxiter=200, policy=precision.F32)
    bicgstab = get_solver("bicgstab")
    ref = bicgstab(make_operator("spmd", cf, policy=precision.F32), b, None, **kw)
    reset_launch_counts()
    var = bicgstab(with_spmd_dots(make_operator("fused", cf, policy=precision.F32)), b,
                   None, **kw)
    counts = launch_counts()
    it = int(var.iterations)
    out = dict(seed=seed, iterations=it, spmd_iterations=int(ref.iterations),
               x_bitwise=bool(var.x.equal(ref.x)), launches=counts)
    check(out["x_bitwise"] and it == out["spmd_iterations"],
          f"seed {seed}: fused with spmd-order dots ({it} iterations) is not the spmd solve "
          f"({out['spmd_iterations']}) bit for bit")
    check(counts == dict(expected_counts(it), dot_mixed=0),
          f"seed {seed}: spmd-order-dot run launch counts {counts}")
    return out


def profile_paper_mesh(torch, iters: int = PROFILE_ITERS) -> dict:
    """Device time by kernel over a few fused iterations at the paper mesh
    (torch.profiler, CUDA activity), and the card's idle share of the
    window.  The problem is built outside the window and one iteration runs
    first, so the window holds only the solver loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import bicgstab, precision, stencil
    from repro_torch.launch.mesh import make_mesh_for_devices

    dev = torch.device("cuda")
    cf = stencil.convection_diffusion(PAPER_MESH, device=dev)
    x = torch.randn(PAPER_MESH, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    b = stencil.rhs_for_solution(cf, x).to(torch.bfloat16)
    cf = cf.astype(torch.bfloat16)
    del x
    kw = dict(tol=0.0, policy=precision.MIXED, backend="fused")
    mesh = make_mesh_for_devices()
    bicgstab.solve_distributed(mesh, cf, b, maxiter=1, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bicgstab.solve_distributed(mesh, cf, b, maxiter=iters, **kw)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            kernels[e.key[:120]] = dict(count=e.count, ms=e.self_device_time_total / 1e3)
    busy = sum(k["ms"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:16])
    return dict(phase="profile", iterations=iters, window_ms=window_ms, busy_ms=busy,
                idle_share=1 - busy / window_ms, kernels_by_device_ms=top)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few paper-mesh iterations with torch.profiler")
    ap.add_argument("--out", type=Path, default=Path("build/chip_smoke.json"),
                    help="where the full JSON record goes (relative to the checkout)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    record: dict = {}
    t_start = time.perf_counter()

    # -- phase 1: the card and the build ---------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    emit(smi)
    record["card"] = smi
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    record["build"] = dict(phase="build", seconds=time.perf_counter() - t0,
                           library=str(lib_path.relative_to(ROOT)))
    emit(record["build"])
    emit(dict(phase="ptxas", kernels=ptxas_summary(lib_path.with_suffix(".log").read_text())))

    # -- phase 2: kernels vs plain versions, then times at the paper mesh ------
    check_kernels(torch)
    times = check_and_time_paper_mesh(torch)
    record["kernels_vs_plain"] = dict(
        shapes=[list(s) for s in CHECK_SHAPES] + [list(PAPER_MESH)],
        dot_tol_over_sum_abs={str(n): dot_tol(n) for n in
                              (math.prod(s) for s in CHECK_SHAPES + [PAPER_MESH])},
        max_abs_err=err, dot_err_over_sum_abs=dot_rel, min_plain_dot_over_tol=dot_signal)
    emit(dict(phase="kernels_vs_plain", **record["kernels_vs_plain"]))
    record["kernel_times"] = times
    emit(dict(phase="kernel_times", shape=list(PAPER_MESH), dtype="bfloat16", **times))

    # -- phase 3: convergence at the CLI's default problem, f32 ---------------
    # One seed's count moves by up to 2 with the dots' summation order alone
    # (the residual tail is spiky near tol 1e-6), so five seeds are compared,
    # and the same solves with spmd-order dots must match spmd exactly.
    runs = []
    for seed in range(PHASE3_SEEDS):
        fused, counts3 = run_cli(["--backend", "fused", "--policy", "f32", "--seed", str(seed)])
        spmd, _ = run_cli(["--backend", "spmd", "--policy", "f32", "--seed", str(seed)])
        runs.append(dict(seed=seed, fused_iterations=fused["iterations"],
                         spmd_iterations=spmd["iterations"],
                         fused_true_rel_residual=fused["true_rel_residual"],
                         spmd_true_rel_residual=spmd["true_rel_residual"],
                         fused_ms_per_iter=fused["ms_per_iter"],
                         spmd_ms_per_iter=spmd["ms_per_iter"], launches=counts3))
        check(fused["converged"], f"seed {seed}: f32 default problem did not converge (fused)")
        check(fused["true_rel_residual"] < 1e-5,
              f"seed {seed}: f32 fused true rel-residual {fused['true_rel_residual']:.3e}")
        check(counts3 == expected_counts(fused["iterations"]),
              f"seed {seed}: launch counts {counts3} != {expected_counts(fused['iterations'])}")
    gaps = sorted(abs(r["fused_iterations"] - r["spmd_iterations"]) for r in runs)
    matched = [dot_order_matched(torch, seed) for seed in range(PHASE3_SEEDS)]
    record["convergence_f32"] = dict(runs=runs, iteration_gaps=gaps,
                                     spmd_order_dots=matched)
    emit(dict(phase="convergence_f32", **record["convergence_f32"]))
    check(gaps[len(gaps) // 2] <= 1 and gaps[-1] <= 2,
          f"fused vs spmd iteration gaps {gaps}: median must be <= 1, max <= 2")

    # -- phase 4: the paper's mesh, bf16_mixed, through the kernels -----------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = [str(s) for s in PAPER_MESH]
    res, counts = run_cli(["--mesh", *mesh, "--backend", "fused", "--policy", "bf16_mixed",
                           "--tol", "0", "--maxiter", str(MAIN_ITERS)])
    moved = iteration_bytes(PAPER_MESH, 2)
    res.update(bytes_per_iter=moved,
               gb_per_s=moved / (res["ms_per_iter"] * 1e-3) / 1e9,
               bound_ms_per_iter=moved / PEAK_BYTES_PER_S * 1e3,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    record["paper_mesh"] = res
    emit(dict(phase="paper_mesh", **res))
    finite = all(math.isfinite(res[k]) for k in ("rel_residual", "true_rel_residual"))
    check(finite and res["rel_residual"] < 1 and res["true_rel_residual"] < 1,
          f"paper-mesh residuals {res['rel_residual']!r}, {res['true_rel_residual']!r}")
    check(res["iterations"] == MAIN_ITERS and not res["breakdown"],
          f"paper mesh ran {res['iterations']} iterations (breakdown {res['breakdown']})")
    check(counts == expected_counts(res["iterations"]),
          f"paper-mesh launch counts {counts} != {expected_counts(res['iterations'])}")

    if args.profile:
        torch.cuda.empty_cache()
        record["profile"] = profile_paper_mesh(torch)
        emit(record["profile"])

    # -- the kernels line ------------------------------------------------------
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        t = times["bf16"][name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=counts[name], max_abs_err=err[name], ms=t["ms"],
                            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    record["kernels"] = kernels
    record["failures"] = failures
    record["seconds"] = time.perf_counter() - t_start
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    emit(smi)
    emit({"kernels": kernels})
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
