#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: builds the kernels,
holds each against its plain PyTorch version, and drives the main path.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a GPU

Phases (one line of output each, JSON where it carries numbers):

1. the card's name and power limit (``nvidia-smi``), then the kernel build
   (``nvcc`` per source, into ``build/repro_torch_kernels/``) and its seconds,
   and each kernel's registers and spills from ``ptxas``: the group passes
   (K2/K2b, K4/K4b) and every instance of K6 must not spill;
2. every kernel against its plain version on the card, at 256x256x256,
   at the default cell's 48x48x32 and at the ragged 37x29x17, in f32 and
   bf16: the stencil (K1) for star7, box27 and star25; the batched stencil
   (K1b) at B = 1 and 3 for the same specs, each slice also against K1; the
   fused passes (K2-K5) and their batched forms (K2b-K5b) at B = 1 and 3
   with distinct per-RHS scalars, each RHS's vectors and dots also against
   the unbatched kernel on its slice, bit for bit; the same passes on
   operands that start off a 16-B boundary with n a whole number of 16-B
   groups (their element-wise form), also bit for bit against the same data
   on 16-B boundaries; and the star7 SpMV with its dot epilogue (K6) at
   every storage and accumulation dtype, its one-dot variant with w read
   from memory and its two-dot variant with w the iterate itself, taken from
   the kernel's ring, each launched twice (the same bits), its vector also
   equal to K1's at the same accumulation; then K1 and K1b (B = 1 and 3), and K6, at the overlap
   schedule's ring slabs, 1x29x17, 37x1x17 and 37x29x1 for star7 (K6 too)
   and box27 and 4x29x17 for star25.  Then at each path's own shapes: K1-K5 and K6 at
   608x608x1536 in bf16 (K1 with bf16 accumulation, K6 with f32, K5 also on
   a self-dot), K1b-K5b at 608^3 x 4 in bf16.  Vector outputs must be
   bitwise equal, dot partials within log2(n) x eps_f32 x sum|a_i b_i| (both
   sides sum the same exact f32 products; only the order differs).  Each kernel's time on those
   inputs (CUDA events, warmed up, mean of 20 launches) goes beside its plain
   version's time, its bound at 3.35 TB/s, a library call's time where one
   PyTorch call computes the same function (K5: ``torch.dot``, K5b:
   ``torch.linalg.vecdot``), the batched kernels beside 4 unbatched launches
   on the same slices, K6's one-dot variant beside K1 with f32 accumulation
   and K1 + K5 on the same inputs, and its two-dot variant; K1 and K1b
   (4 RHS) for box27 and star25 at 256^3 beside their bounds; and the
   redesigned kernels (K1, K1b, K5, K5b, K2, K2b, K4, K4b, K6) beside their
   times before the redesign;
3. the CLI's default problem (48x48x32 convdiff star7, f32, tol 1e-6)
   through ``--backend fused`` for seeds 0-4: each must converge to a true
   relative residual below 1e-5, with the kernels' launch counts, and its
   iteration count must stay within 8 of the ``spmd`` backend's on every
   seed (``SEED_GAP``) and within 2 on the mean over the seeds
   (``MEAN_GAP``).  The same solves with the fused
   path's dots summed in the spmd backend's order (``Policy.dot``) must give
   the spmd solve bit for bit, iteration count included: the two paths
   differ only in the dots' summation order, which alone moves one seed's
   count by several iterations;
4. the paper's mesh (``cs1_paper``, 608x608x1536, star7 convdiff,
   ``bf16_mixed``) through ``--backend fused`` for 30 iterations at tol 0:
   ms/iter, GB/s against the bytes an iteration must move, finite residuals
   below 1, and launch counts of exactly 2 stencil + 1 of each fused pass
   per iteration plus 2 dot_mixed at setup;
5. the batched main path: ``joule_600`` (608^3) with ``--nrhs 4``,
   ``bf16_mixed``, ``--backend fused``, 30 iterations at tol 0: ms per
   iteration and per RHS-iteration, GB/s against the batched bytes model
   (coefficients read once per SpMV), peak memory, finite per-RHS residuals
   below 1, and exactly 2 K1b and 1 each of K2b-K4b per iteration plus K5b
   at iterations + 2, with no unbatched launch;
6. batched semantics at the default cell (f32, tol 1e-6), 4 RHS for seeds
   0-4: every RHS converges to a true residual below 1e-5, each RHS's x and
   iteration count equal an unbatched fused solve of that RHS bit for bit,
   and a (1,)+shape solve equals the unbatched one bit for bit;
7. ``solve_ref_fused``: at the default cell, f32, seeds 0-4, it converges
   and, like the fused path in phase 3, its counts stay within 8 of the
   ``spmd`` backend's on every seed and within 2 on the mean (the fused
   path's ``dot_mixed`` and this
   path's SpMV epilogue sum <r0,s> in different orders, so the two fused
   paths are each held to spmd, not to each other); at 608x608x1536 in bf16 it
   runs 30 iterations with exactly 2 K6 and 1 each of K3 and K4 per
   iteration, timed against its own bytes model.
8. the solver and preconditioner stack.  (a) At the default cell, f32,
   seeds 0-4, ``--maxiter 2000``: ``cg`` and ``pipelined_cg`` (tol 1e-5) on
   poisson, ``pipelined_bicgstab`` on convdiff, BiCGStab with ``--precond
   chebyshev --cheb-degree 3`` on poisson and with ``--precond jacobi`` on
   heterogeneous, each through the CLI's fused path and the spmd backend,
   with each path's limits in ``SLICE_PATHS``: both converge to a true
   relative residual below 10 x tol (20 x for the pipelined solvers, whose
   recurrence norm drifts from the true residual; the Jacobi run may
   instead stop at a flagged breakdown, as the JAX package's does on this
   family), and the fused launch counts are exact.  The fused kernels with
   spmd-order dots give the plain solve bit for bit, iteration count and
   breakdown included: the spmd solve, or for Jacobi's raw diagonal the
   spmd apply with the diagonal split off as the fused operator splits it
   (``spmd_split``); that SpMV is also held to spmd's unsplit one within 8
   f32 epsilons of its terms.  ``cg`` and Chebyshev keep the gap rule phase
   3 had before the seed repair (median gap within 1, every gap within 2),
   and Chebyshev takes at most 0.7 x plain BiCGStab's iterations on both
   backends.  ``--refine`` (bf16 inner
   solves, convdiff) falls at every outer step to below 1e-5 and launches
   no kernel; ``cg`` and ``pipelined_bicgstab`` with 4 RHS equal their solo
   fused solves bit for bit per RHS; and ``make_iteration_fn
   (backend="fused")`` on the fused loop's initial state gives its first
   step bit for bit.  (b) Each path at 608x608x1536, ``bf16_mixed``, 30
   iterations at tol 0 through the CLI: ms/iter against its bytes model,
   peak memory, finite residuals below 1 (pipelined CG's true residual
   drifts in bf16 whatever the dots' rounding: below 100, and the kernels
   with spmd-order dots must give the spmd solve of the same system bit for
   bit), exact launch counts; and one
   ``make_iteration_fn`` call timed beside phase 4.  (c) The same seed
   draws the same coefficients and x_true for the card as for the CPU, bit
   for bit (whether b is equal is recorded).

9. observability, the tuning cache and the performance model, all written
   into a temporary directory (``REPRO_TORCH_TUNING_CACHE`` and
   ``--run-dir`` point there).  (a) ``tuning.autotune_cell`` sweeps the
   stencil kernel's plans at ``cs1_paper`` (608x608x1536, bf16) and at
   ``joule_600`` x 4 (608^3, 4 RHS, where the RHS chunk matters) on the
   solve's own one-rank fabric, where every candidate runs what the solve
   runs (one pad and one K1/K1b): every candidate's output equals the
   default's bit for bit on the sweep's inputs; one line per candidate
   gives its CUDA-event ms, the bytes bound at 3.35 TB/s, its share of it,
   and the card.  On a synthetic 2x2 exchange every swept plan's fused and
   split ring forms equal each other and the default's split form, bit for
   bit.  Then the CLI with ``--autotune`` at
   ``cs1_paper`` (30 iterations, tol 0) must find the sweep's entry (a cache
   hit) and give phase 4's residuals bit for bit and its launch counts.
   (b) ``--obs --run-dir``: the manifest passes ``validate_manifest`` and
   names the card and its power limit, ``events.jsonl`` holds one solve
   event of 30 iterations and a ``collectives`` event of 91 AllReduces
   (1 + 3 x 30) and 0 ppermutes, ``trace.json`` holds the solve, operator
   and halo spans, and residuals and launch counts equal phase 4's; its
   ms/iter is recorded beside phase 4's.  (c) ``--profile`` for 5
   iterations: ``<run_dir>/torch_profile`` holds a trace with the stencil
   kernel's device events.  (d) ``perfmodel.iteration_time_model`` for
   ``cs1_paper`` on one card beside phase 4's ms/iter and the bytes bound.

10. the SIMPLE CFD application (``python -m repro_torch.launch.cfd``), whose
   2D fields have no kernel: none of its runs may launch K1-K6.  (a) The
   ``cavity_ghia`` cell (n=32, Re=100, spmd, f32, ``--outer 400 --tol
   5e-6``) through the CLI on the card and on the CPU: the card's run
   reaches tol and passes the Ghia bands, its field is divergence-free to
   1e-4 with wall faces exactly 0, and its centerline is within 1e-3 of
   the CPU run's; both outer-iteration counts are recorded.  (b)
   ``cavity_raw_jacobi`` and ``cavity_pipelined`` each converge; the cavity
   at ``bf16_mixed`` for 50 outer iterations is finite and its three
   systems, formed as raw rows in bf16 storage, have no zero diagonal.
   (c) The transient cavity at n=1024 (dt 0.05, 6 steps x 5 outer
   iterations, a checkpoint every 2 steps) with a fault injected at step 3
   equals the uninterrupted march bit for bit, metrics included; its last
   checkpoint restored on the CPU equals the card's state bit for bit; the
   channel at the same size keeps its outlet flux within 1e-5 of u_in.
   (d) The steady cavity at n=8192 (67.1M cells), f32, 10 outer iterations
   from rest: ms per outer iteration, peak memory, ``measure_solve_share``
   (3 reps: the paper's Table II solve/formation split) and the device
   launches of one outer iteration (torch.profiler); and ms per outer
   iteration at n=4096 in ``bf16_mixed``.  (d) records and limits nothing.

11. the dense LM serving path (``repro_torch.models``), which reaches no
   kernel: none of its runs may launch K1-K6, and the matrix-product flags
   it sets (no TF32, no bf16 reduced-precision reduction) are recorded.
   (a) The four smoke configs (B 2, T 32, 8 decodes) and (b) ``qwen2_1_5b``
   at full width (28 layers, B 1, T 64, 4 decodes), on one set of seeded
   weights, served on the card and on the CPU in f32 and in bf16, every
   decode fed the CPU f32 run's greedy token: f32 logits within 16 f32 ulps
   of the CPU's largest |logit| at smoke width (the tests' tolerance) and
   2^-10 of it at full width; the card's bf16 logits at most 2 x as far
   from the CPU's f32 logits as the CPU's bf16 logits are; greedy tokens
   equal wherever the CPU's top-2 gap exceeds the tolerance.  (c)
   ``qwen2_1_5b`` serving 8 requests of 2,048 prompt tokens and 128 greedy
   new tokens (prefill + 127 decodes), twice: prefill ms and tokens/s,
   decode ms/step and tokens/s, peak memory, each beside its bound (the
   prefill's operations at 989 TFLOP/s or its bytes, one decode step's
   weights and cache bytes at 3.35 TB/s).  (d) 32,768 prompt tokens + 32 at
   batch 1 (``prefill_32k``/``decode_32k`` with the batch cut from 32 and
   128).  (e) ``gemma3_12b`` at full width cut to one period (6 layers: 5
   windowed at 1,024, 1 global) over 4,096 + 16 tokens.  Every logit of
   (c)-(e) must be finite.

12. the multi-rank solve over ``torch.distributed``: the parent, whose
   kernels are built, starts four ranks on this one card under ``torchrun
   --nproc-per-node 4`` with the gloo backend (every slab and AllReduce
   operand staged through the host; NCCL refuses two ranks on one card),
   each on its block of a 2x2 fabric.  (a) ``global_apply``'s SpMV through
   K1 and K1b (B = 0 and 3) at 48x48x32 and 608x608x1536 for star7 and at
   256^3 for box27 and star25, f32 and bf16, in the blocking, overlap-split
   and overlap-fused forms: every form the same bits on every rank, the
   gathered output the one-rank K1 of the whole array bit for bit (inputs
   from an integer hash of the global index, so no array crosses), and
   per rank exactly 1, 1 + 4 ring slabs and 1 launches.  (b) The CLI at the
   default cell, ``--backend fused``, f32, seeds 0-4: a true residual below
   1e-5, gaps to the four-rank spmd solve within 8 and 2 on the mean, with
   spmd-order dots the spmd solve bit for bit, per rank 1 + 3n AllReduces,
   8n permutes and the split-ring launch counts.  (c) ``cs1_paper`` on the
   four ranks, 30 iterations: finite residuals below 1, per rank K1 2 x (1 +
   4) per iteration, K2-K4 1 each, K5 1 each and 2 at setup, its peak memory,
   ms/iter and bytes staged through the host per iteration, recorded as four
   gloo ranks sharing one card (not a speed of the system; no limit).  (f)
   The same run with ``--autotune --obs --run-dir``: rank 0 sweeps (the
   fused ring among the candidates) and writes the cache, the others hit
   it; 12c's residuals bit for bit, the winner's launch counts, one bundle
   naming the world, backend and rank-to-device map with every rank's
   91 AllReduces and 240 permutes.  (e) The ``cavity_ghia`` cell on the 2x2
   fabric passes the Ghia bands within 1e-3 of phase 10a's centerline and
   launches no kernel.  (d) Phase 4's run under ``torchrun`` with one nccl
   rank: phase 4's residuals and launch counts bit for bit.  A rank that
   fails, or ranks that pass their time limit (killed as a process group),
   fail the phase.

``--profile`` adds a torch.profiler trace of a few iterations of each
measured path (phases 4, 5, 7 and 8b) and of 5 decode steps of 11c:
device time by kernel and the card's idle share.

The ``kernels`` line lists every kernel with the launches of the path that
runs it (K1-K5: phase 4; K1b-K5b: phase 5; K6: phase 7's paper-mesh run).
It exits non-zero, without the last line, when any phase fails, when no CUDA
device is present, or when the package is missing beside it.  The full
record goes to ``--out`` (default ``build/chip_smoke.json``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from collections.abc import Callable
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores, NVIDIA data sheet
EPS_F32 = 2.0 ** -23
PAPER_MESH = (608, 608, 1536)
JOULE_MESH = (608, 608, 608)  # configs/stencil_cs1.py joule_600: the batched path's mesh
DEFAULT_MESH = (48, 48, 32)  # the CLI's default cell (phases 3, 6, 7)
CHECK_SHAPES = [(256, 256, 256), DEFAULT_MESH, (37, 29, 17)]
#: the overlap schedule's ring slabs (depth r, down to one plane thick), stencil only
SLAB_SHAPES = {"star7": [(1, 29, 17), (37, 1, 17), (37, 29, 1)],
               "box27": [(1, 29, 17), (37, 1, 17), (37, 29, 1)],
               "star25": [(4, 29, 17)]}
CHECK_BATCHES = (1, 3)
FAMILY_MESH = (256, 256, 256)   # box27 and star25 timed here, off the measured paths
#: the redesigned kernels' times before their redesign, as PERF.md's kernel table
#: gives them in brackets (NVIDIA H100 80GB HBM3 at 700 W), printed beside the new ones
EARLIER_MS = {"stencil_nd": 6.99, "stencil_nd_batched": 7.72, "dot_mixed": 1.98,
              "dot_mixed_batched": 1.81, "update_q_dots": 2.81, "update_q_dots_batched": 3.15,
              "update_p": 2.87, "update_p_batched": 3.16, "stencil7_dot": 6.62}
#: the group passes (K2, K4), each in f32 and bf16, wide and element-wise:
#: ptxas must report no spill for any of the four instances of each
GROUP_KERNELS = ("update_q_dots_kernel", "update_p_kernel")
#: K6 on the x-march: 2 accumulations x (1 f32 + 2 bf16 stagings) x (one dot with
#: w from memory, two dots with w from the ring); ptxas must report no spill for
#: any of them
DOT_KERNEL, DOT_INSTANCES = "stencil7_dot_kernel", 12
MAIN_ITERS = 30
MAIN_NRHS = 4
PHASE3_SEEDS = 5
PROFILE_ITERS = 5

_SRC = "src/repro_torch/kernels/csrc/"
_TPU = "src/repro/kernels/"
#: name -> (CUDA source, the TPU kernel it replaces, the phase whose run gives its launches)
KERNELS = {
    "stencil_nd": (_SRC + "stencil_nd.cu", _TPU + "stencil_nd/kernel.py:120", "paper_mesh"),
    "update_q_dots": (_SRC + "fused_iter.cu", _TPU + "fused_iter/kernel.py:74", "paper_mesh"),
    "update_xr_dots": (_SRC + "fused_iter.cu", _TPU + "fused_iter/kernel.py:124", "paper_mesh"),
    "update_p": (_SRC + "fused_iter.cu", _TPU + "fused_iter/kernel.py:168", "paper_mesh"),
    "dot_mixed": (_SRC + "fused_iter.cu", _TPU + "fused_iter/kernel.py:203", "paper_mesh"),
    "stencil_nd_batched": (_SRC + "stencil_nd.cu", _TPU + "stencil_nd/kernel.py:78", "batched"),
    "update_q_dots_batched": (_SRC + "fused_iter.cu", _TPU + "fused_iter/kernel.py:79",
                              "batched"),
    "update_xr_dots_batched": (_SRC + "fused_iter.cu", _TPU + "fused_iter/kernel.py:130",
                               "batched"),
    "update_p_batched": (_SRC + "fused_iter.cu", _TPU + "fused_iter/kernel.py:174", "batched"),
    "dot_mixed_batched": (_SRC + "fused_iter.cu", _TPU + "fused_iter/kernel.py:208", "batched"),
    "stencil7_dot": (_SRC + "stencil7_dot.cu", _TPU + "stencil_nd/fused.py:104", "ref_fused"),
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


def same_bits(name, got, want, label, against="the unbatched kernel on its slice") -> None:
    """Outputs (vectors and 0-d dots alike) equal bit for bit."""
    check(all(g.equal(w) for g, w in zip(got, want)),
          f"{name} {label}: not bitwise equal to {against}")


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


def batch_scalars(torch, nb: int):
    """Distinct per-RHS alpha, omega and beta, ``[nb]`` f32 on the card."""
    dev = torch.device("cuda")
    return tuple(torch.linspace(lo, hi, nb, device=dev)
                 for lo, hi in ((0.3, 0.9), (-1.3, -0.5), (0.2, 0.8)))


def check_fused_iter_batched(torch, v, label) -> None:
    """K2b-K5b on ``(B, n)`` operands with distinct per-RHS scalars: against
    their plain versions, and each RHS's vectors and dots against the
    unbatched kernel on its slice, bit for bit."""
    from repro_torch.kernels.fused_iter import kernel as fk
    from repro_torch.kernels.fused_iter import ref as fref

    nb = v[0].shape[0]
    a, o, b = batch_scalars(torch, nb)
    name = "update_q_dots_batched"
    got, want = fk.update_q_dots_batched(a, *v[:3]), fref.update_q_dots_batched_ref(a, *v[:3])
    vec_eq(name, got[0], want[0], label)
    for i in range(nb):
        dot_close(name, got[1][i], want[1][i], got[0][i], v[2][i], f"{label} rhs {i} <q,y>")
        dot_close(name, got[2][i], want[2][i], v[2][i], v[2][i], f"{label} rhs {i} <y,y>")
        same_bits(name, [t[i] for t in got], fk.update_q_dots(a[i], *(t[i] for t in v[:3])),
                  f"{label} rhs {i}")
    del got, want
    name = "update_xr_dots_batched"
    got, want = fk.update_xr_dots_batched(a, o, *v), fref.update_xr_dots_batched_ref(a, o, *v)
    vec_eq(name, got[0], want[0], label + " x")
    vec_eq(name, got[1], want[1], label + " r")
    for i in range(nb):
        dot_close(name, got[2][i], want[2][i], v[4][i], got[1][i], f"{label} rhs {i} <r0,r>")
        dot_close(name, got[3][i], want[3][i], got[1][i], got[1][i], f"{label} rhs {i} <r,r>")
        same_bits(name, [t[i] for t in got], fk.update_xr_dots(a[i], o[i], *(t[i] for t in v)),
                  f"{label} rhs {i}")
    del got, want
    name = "update_p_batched"
    got = fk.update_p_batched(b, o, *v[:3])
    vec_eq(name, got, fref.update_p_batched_ref(b, o, *v[:3]), label)
    for i in range(nb):
        same_bits(name, [got[i]], [fk.update_p(b[i], o[i], *(t[i] for t in v[:3]))],
                  f"{label} rhs {i}")
    name = "dot_mixed_batched"
    got, want = fk.dot_mixed_batched(v[0], v[1]), fref.dot_mixed_batched_ref(v[0], v[1])
    for i in range(nb):
        dot_close(name, got[i], want[i], v[0][i], v[1][i], f"{label} rhs {i}")
        same_bits(name, [got[i]], [fk.dot_mixed(v[0][i], v[1][i])], f"{label} rhs {i}")


def check_off_boundary(torch, v, label) -> None:
    """K2-K5 and K2b-K5b on operands that start off a 16-B boundary while n
    is a whole number of 16-B groups (views ``buf[1:]`` of one-longer
    buffers), which alone sends the group passes to their element-wise form:
    against their plain versions, each RHS against the B = 1 launch, and
    against the same data on 16-B boundaries (the wide form) bit for bit,
    dots included.  ``v`` holds five ``(B, n)`` operands."""
    from repro_torch.kernels.fused_iter import kernel as fk

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)

    w = [off(t) for t in v]
    check(all(t.data_ptr() % 16 for t in w), f"{label}: the views start on a 16-B boundary")
    a, o, b = scalars(torch)
    ab, ob, bb = batch_scalars(torch, v[0].shape[0])
    one = lambda x: [t[0] for t in x]   # RHS 0 as a flat vector, off the boundary too
    check_fused_iter(torch, a, o, b, one(w), label + " B=1")
    check_fused_iter_batched(torch, w, f"{label} B={v[0].shape[0]}")
    passes = {
        "update_q_dots": lambda x: fk.update_q_dots(a, *one(x)[:3]),
        "update_p": lambda x: [fk.update_p(b, o, *one(x)[:3])],
        "dot_mixed": lambda x: [fk.dot_mixed(*one(x)[:2])],
        "update_q_dots_batched": lambda x: fk.update_q_dots_batched(ab, *x[:3]),
        "update_p_batched": lambda x: [fk.update_p_batched(bb, ob, *x[:3])],
        "dot_mixed_batched": lambda x: [fk.dot_mixed_batched(*x[:2])],
    }
    for name, fn in passes.items():
        same_bits(name, fn(w), fn(v), label, against="the same data on 16-B boundaries")


def check_stencil_batched(torch, vp, cfs, spec, acc, label) -> None:
    """K1b against its plain version, and each slice against K1."""
    from repro_torch.kernels.stencil_nd.kernel import stencil_nd, stencil_nd_batched
    from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref

    kw = dict(radius=spec.radius, accum_dtype=acc)
    got = stencil_nd_batched(vp, cfs, spec.offsets, **kw)
    vec_eq("stencil_nd_batched", got, stencil_nd_padded_ref(vp, cfs, spec.offsets, **kw), label)
    for i in range(vp.shape[0]):
        same_bits("stencil_nd_batched", [got[i]], [stencil_nd(vp[i], cfs, spec.offsets, **kw)],
                  f"{label} slice {i}")


def check_stencil7_dot(torch, vp, w, cfs, acc, label) -> None:
    """K6 at accumulation ``acc`` against its plain version: the one-dot
    variant with ``w`` read from memory and the two-dot variant with w the
    iterate itself, taken from the kernel's ring; vectors bitwise, dots
    within dot_tol.  A second launch gives the same bits, and the vector is
    K1's at the same accumulation bit for bit."""
    from repro_torch.core.stencil import STAR7
    from repro_torch.kernels.stencil_nd.fused import stencil7_dots_padded
    from repro_torch.kernels.stencil_nd.kernel import stencil_nd
    from repro_torch.kernels.stencil_nd.ref import stencil7_dots_padded_ref

    name = "stencil7_dot"
    label = f"{label} accum {str(acc).split('.')[-1]}"
    inner = vp[1:-1, 1:-1, 1:-1].contiguous()
    run = lambda ww, two: [t for t in stencil7_dots_padded(vp, ww, cfs, two_dots=two,
                                                           accum_dtype=acc) if t is not None]
    for two, ww in ((False, w), (True, None)):
        form = f"{label} two_dots={two}" + (" w from the ring" if ww is None else "")
        got = run(ww, two)
        want = stencil7_dots_padded_ref(vp, ww, cfs, STAR7.offsets, two_dots=two, accum_dtype=acc)
        vec_eq(name, got[0], want[0], form)
        dot_close(name, got[1], want[1], inner if ww is None else ww, got[0], form + " <w,u>")
        if two:
            dot_close(name, got[2], want[2], got[0], got[0], form + " <u,u>")
        same_bits(name, got, run(ww, two), form, against="a second launch")
    vec_eq(name, got[0], stencil_nd(vp, cfs, STAR7.offsets, radius=1, accum_dtype=acc),
           f"{label} vs K1 at the same accumulation")


def check_stencil(torch, gen, shape, dtype, sname) -> None:
    """K1 and K1b (B = 1 and 3) for one spec, shape and dtype against the
    plain version, every accumulation; K6 too for star7, at both
    accumulations."""
    from repro_torch.core import stencil
    from repro_torch.kernels.stencil_nd.kernel import stencil_nd
    from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref

    dev = torch.device("cuda")
    spec = stencil.get_spec(sname)
    rnd = lambda shp: torch.randn(shp, generator=gen, device=dev).to(dtype)
    label = f"{'x'.join(map(str, shape))} {str(dtype).split('.')[-1]}"
    accs = [torch.float32] if dtype == torch.float32 else [torch.bfloat16, torch.float32]
    r = spec.radius
    vp = rnd(tuple(s + 2 * r for s in shape))   # random halo: indexing is checked
    cfs = [rnd(shape) * 0.2 for _ in spec.offsets]
    for acc in accs:
        got = stencil_nd(vp, cfs, spec.offsets, radius=r, accum_dtype=acc)
        want = stencil_nd_padded_ref(vp, cfs, spec.offsets, radius=r, accum_dtype=acc)
        vec_eq("stencil_nd", got, want, f"{sname} {label} accum {str(acc).split('.')[-1]}")
    if sname == "star7":
        w = rnd(shape)
        for acc in (torch.float32, torch.bfloat16):
            check_stencil7_dot(torch, vp, w, cfs, acc, label)
    for nb in CHECK_BATCHES:
        vpb = rnd((nb,) + tuple(s + 2 * r for s in shape))
        for acc in accs:
            check_stencil_batched(torch, vpb, cfs, spec, acc,
                                  f"{sname} {label} B={nb} accum {str(acc).split('.')[-1]}")


def check_kernels(torch) -> None:
    """Every kernel vs its plain version at CHECK_SHAPES, and the stencil at
    the ring slabs of SLAB_SHAPES."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            rnd = lambda shp: torch.randn(shp, generator=gen, device=dev).to(dtype)
            label = f"{'x'.join(map(str, shape))} {str(dtype).split('.')[-1]}"
            for sname in ("star7", "box27", "star25"):
                check_stencil(torch, gen, shape, dtype, sname)
            check_fused_iter(torch, *scalars(torch), [rnd(math.prod(shape)) for _ in range(5)],
                             label)
            for nb in CHECK_BATCHES:
                check_fused_iter_batched(torch, [rnd((nb, math.prod(shape))) for _ in range(5)],
                                         f"{label} B={nb}")
            if math.prod(shape) % 8 == 0:   # whole 16-B groups in both dtypes
                check_off_boundary(torch, [rnd((CHECK_BATCHES[-1], math.prod(shape)))
                                           for _ in range(5)], label + " off 16-B")
    for sname, shapes in SLAB_SHAPES.items():
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                check_stencil(torch, gen, shape, dtype, sname)
    torch.cuda.synchronize()


def _rec(torch, out, name, kern, plain, moved, flops, library=None, **beside) -> None:
    """Time a kernel, its plain version and a library call on the same
    inputs, with the bound of the work; ``beside`` names other yardsticks."""
    out[name] = dict(ms=cuda_ms(torch, kern), plain_ms=cuda_ms(torch, plain),
                     library_ms=None if library is None else cuda_ms(torch, library),
                     bytes=moved, flops=flops,
                     **{k + "_ms": cuda_ms(torch, fn) for k, fn in beside.items()})
    out[name]["bound_ms"], out[name]["bound_by"] = bound(moved, flops)


def check_and_time_paper_mesh(torch) -> dict:
    """Each kernel against its plain version at the main path's shape and
    dtype (608x608x1536 bf16, star7, bf16 accumulation; K6 with f32
    accumulation, as solve_ref_fused runs it), then the times of both on the
    same inputs, with bytes and flops of the work for the bound."""
    from repro_torch.core import stencil
    from repro_torch.kernels.fused_iter import kernel as fk
    from repro_torch.kernels.fused_iter import ref as fref
    from repro_torch.kernels.stencil_nd.fused import stencil7_dots_padded
    from repro_torch.kernels.stencil_nd.kernel import stencil_nd
    from repro_torch.kernels.stencil_nd.ref import stencil7_dots_padded_ref, stencil_nd_padded_ref

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
    # a self-dot, as the solver's setup takes <b,b>: positive terms show summation drift
    dot_close("dot_mixed", fk.dot_mixed(v[1], v[1]), fref.dot_mixed_ref(v[1], v[1]), v[1], v[1],
              label + " self-dot")
    w = v[4].view(PAPER_MESH)
    check_stencil7_dot(torch, vp, w, cfs, torch.float32, label)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    vec = nbytes(v[0])
    out = {}
    rec = lambda *args, **extra: _rec(torch, out, *args, **extra)
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
    # K6 as solve_ref_fused runs it: the one-dot variant (<r0,s>) reads w
    # from memory, 9 words a point, beside K1 with f32 accumulation and K1 +
    # K5 on the same inputs; the two-dot variant (<q,y>, <y,y>) takes w = q
    # from its ring, 8 words
    k1_f32 = lambda: stencil_nd(vp, cfs, spec.offsets, radius=1, accum_dtype=torch.float32)
    rec("stencil7_dot", lambda: stencil7_dots_padded(vp, w, cfs, two_dots=False),
        lambda: stencil7_dots_padded_ref(vp, w, cfs, spec.offsets, two_dots=False),
        nbytes(vp, w, *cfs) + vec, (2 * spec.n_offsets + 2) * n, k1_f32=k1_f32,
        k1_plus_k5=lambda: fk.dot_mixed(v[4], k1_f32().view(-1)))
    rec("stencil7_two_dots", lambda: stencil7_dots_padded(vp, None, cfs, two_dots=True),
        lambda: stencil7_dots_padded_ref(vp, None, cfs, spec.offsets, two_dots=True),
        nbytes(vp, *cfs) + vec, (2 * spec.n_offsets + 4) * n)
    del vp, cfs, v, w
    torch.cuda.empty_cache()
    # dot_mixed in f32 beside torch.dot on the same f32 inputs
    x, y = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
    f32 = dict(shape=list(PAPER_MESH), ms=cuda_ms(torch, lambda: fk.dot_mixed(x, y)),
               torch_dot_ms=cuda_ms(torch, lambda: torch.dot(x, y)))
    f32["bound_ms"], f32["bound_by"] = bound(nbytes(x, y), 2 * n)
    del x, y
    torch.cuda.empty_cache()
    return {"bf16": out, "dot_mixed_f32": f32}


def check_and_time_batched(torch) -> dict:
    """K1b-K5b at the batched path's shape (608^3 x 4 RHS, bf16; K1b with
    bf16 accumulation, as bf16_mixed runs it): against their plain versions
    and, per RHS, the unbatched kernels, then timed beside their plain
    versions, 4 unbatched launches on the same slices and the bound."""
    from repro_torch.core import stencil
    from repro_torch.kernels.fused_iter import kernel as fk
    from repro_torch.kernels.fused_iter import ref as fref
    from repro_torch.kernels.stencil_nd.kernel import stencil_nd, stencil_nd_batched
    from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref

    dev, dt, nb = torch.device("cuda"), torch.bfloat16, MAIN_NRHS
    gen = torch.Generator(device=dev).manual_seed(2)
    n = math.prod(JOULE_MESH)
    spec = stencil.STAR7
    vp = torch.randn((nb,) + tuple(s + 2 for s in JOULE_MESH), generator=gen,
                     device=dev).to(dt)
    cfs = [(0.1 * torch.randn(JOULE_MESH, generator=gen, device=dev)).to(dt)
           for _ in spec.offsets]
    v = [torch.randn((nb, n), generator=gen, device=dev).to(dt) for _ in range(5)]
    a, o, b = batch_scalars(torch, nb)
    label = f"{'x'.join(map(str, JOULE_MESH))} x {nb} bfloat16"
    check_stencil_batched(torch, vp, cfs, spec, dt, label + " accum bfloat16")
    check_fused_iter_batched(torch, v, label)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    kw = dict(radius=1, accum_dtype=dt)
    each = lambda fn: lambda: [fn(i) for i in range(nb)]   # nb unbatched launches
    vec = nbytes(v[0])
    out = {}
    rec = lambda *args, **extra: _rec(torch, out, *args, **extra)
    rec("stencil_nd_batched", lambda: stencil_nd_batched(vp, cfs, spec.offsets, **kw),
        lambda: stencil_nd_padded_ref(vp, cfs, spec.offsets, **kw),
        nbytes(vp, *cfs) + vec, 2 * spec.n_offsets * n * nb,
        unbatched=each(lambda i: stencil_nd(vp[i], cfs, spec.offsets, **kw)))
    rec("update_q_dots_batched", lambda: fk.update_q_dots_batched(a, *v[:3]),
        lambda: fref.update_q_dots_batched_ref(a, *v[:3]), 4 * vec, 6 * n * nb,
        unbatched=each(lambda i: fk.update_q_dots(a[i], *(t[i] for t in v[:3]))))
    rec("update_xr_dots_batched", lambda: fk.update_xr_dots_batched(a, o, *v),
        lambda: fref.update_xr_dots_batched_ref(a, o, *v), 7 * vec, 10 * n * nb,
        unbatched=each(lambda i: fk.update_xr_dots(a[i], o[i], *(t[i] for t in v))))
    rec("update_p_batched", lambda: fk.update_p_batched(b, o, *v[:3]),
        lambda: fref.update_p_batched_ref(b, o, *v[:3]), 4 * vec, 4 * n * nb,
        unbatched=each(lambda i: fk.update_p(b[i], o[i], *(t[i] for t in v[:3]))))
    rec("dot_mixed_batched", lambda: fk.dot_mixed_batched(v[0], v[1]),
        lambda: fref.dot_mixed_batched_ref(v[0], v[1]), 2 * vec, 2 * n * nb,
        library=lambda: torch.linalg.vecdot(v[0], v[1]),
        unbatched=each(lambda i: fk.dot_mixed(v[0][i], v[1][i])))
    del vp, cfs, v
    torch.cuda.empty_cache()
    return out


def time_family(torch) -> dict:
    """K1 and K1b (4 RHS) for box27 and star25 at FAMILY_MESH in bf16 with
    bf16 accumulation, off the measured paths, beside their bounds."""
    from repro_torch.core import stencil
    from repro_torch.kernels.stencil_nd.kernel import stencil_nd, stencil_nd_batched

    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    n = math.prod(FAMILY_MESH)
    out = {}
    for sname in ("box27", "star25"):
        spec = stencil.get_spec(sname)
        r = spec.radius
        vp = torch.randn((MAIN_NRHS,) + tuple(s + 2 * r for s in FAMILY_MESH), generator=gen,
                         device=dev).to(dt)
        cfs = [(0.1 * torch.randn(FAMILY_MESH, generator=gen, device=dev)).to(dt)
               for _ in spec.offsets]
        kw = dict(radius=r, accum_dtype=dt)
        k1 = dict(ms=cuda_ms(torch, lambda: stencil_nd(vp[0], cfs, spec.offsets, **kw)))
        k1["bound_ms"], k1["bound_by"] = bound(nbytes(vp[0], *cfs) + 2 * n,
                                               2 * spec.n_offsets * n)
        k1b = dict(ms=cuda_ms(torch, lambda: stencil_nd_batched(vp, cfs, spec.offsets, **kw)))
        k1b["bound_ms"], k1b["bound_by"] = bound(nbytes(vp, *cfs) + 2 * n * MAIN_NRHS,
                                                 2 * spec.n_offsets * n * MAIN_NRHS)
        out[sname] = {"stencil_nd": k1, f"stencil_nd_batched_x{MAIN_NRHS}": k1b}
        del vp, cfs
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path through the CLI's entry point
# ---------------------------------------------------------------------------

def iteration_bytes(shape, itemsize: int, radius: int = 1, n_off: int = 6, nrhs: int = 1) -> int:
    """Bytes one fused BiCGStab iteration must move for ``nrhs`` right-hand
    sides: each op's inputs read once and its outputs written once, with the
    batched SpMV reading each coefficient field once for all of them."""
    n = math.prod(shape)
    n_pad = math.prod(s + 2 * radius for s in shape)
    pad = nrhs * (n + n_pad)                    # read v, write its zero-padded copy
    spmv = nrhs * n_pad + n_off * n + nrhs * n  # read the padded v and the fields, write u
    fused = nrhs * (3 + 4 + 7 + 4 + 2) * n      # q_in, update_q_dots, update_xr_dots,
    return (2 * (pad + spmv) + fused) * itemsize  # update_p, dot_mixed


def ref_fused_iteration_bytes(shape, itemsize: int) -> int:
    """Bytes one ``solve_ref_fused`` iteration must move: 2 zero pads, K6's
    one-dot variant (padded p, 6 fields and r0 in; s out), its two-dot
    variant (padded q and 6 fields in, w = q being the padded iterate; y
    out), the inline q (r, s in; q out), update_xr_dots (7 words) and
    update_p (4 words)."""
    n = math.prod(shape)
    n_pad = math.prod(s + 2 for s in shape)
    k6 = (n_pad + 8 * n) + (n_pad + 7 * n)
    return (2 * (n + n_pad) + k6 + (3 + 7 + 4) * n) * itemsize


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes per compiled kernel, from ``-Xptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


#: phases 3 and 7 hold a fused BiCGStab path's f32 iteration count to spmd's
#: on every seed within SEED_GAP and on the mean over seeds 0-4 within
#: MEAN_GAP.  The dots' summation order alone moves one seed's count on
#: convdiff: over seeds 0-19 of the default cell on an H100
#: (scripts/iteration_gaps.py), the fused path and solve_ref_fused each read
#: up to 6 iterations from spmd's, and the same spmd solve on the card and on
#: the CPU up to 4, with no kernel involved; the signed gaps averaged +0.00,
#: -0.10 and +0.10.  A kernel whose dots slowed or sped convergence would move
#: the mean; one that broke a seed would pass SEED_GAP.
SEED_GAP, MEAN_GAP = 8, 2
#: 8a's ``cg`` and Chebyshev keep the rule phases 3 and 7 had before the seed
#: repair: the median gap within 1, every gap within 2 (over seeds 0-19 on an
#: H100 their largest gaps read 0 and 3; seeds 0-4, 0 and 2)
MEDIAN_GAP, EVERY_GAP = 1, 2


def gap_check(what: str, signed: list[int], every: int, median: int | None = None,
              mean: int | None = None) -> dict:
    """The signed iteration gaps of a fused path against spmd: each within
    ``every``, and their median and mean within the limits given."""
    mid, avg = sorted(signed)[len(signed) // 2], sum(signed) / len(signed)
    check(max(map(abs, signed)) <= every,
          f"{what} iteration gaps {signed}: each must be within +-{every}")
    if median is not None:
        check(abs(mid) <= median, f"{what} iteration gaps {signed}: the median {mid:+d} "
                                  f"must be within +-{median}")
    if mean is not None:
        check(abs(avg) <= mean, f"{what} iteration gaps {signed}: the mean {avg:+.2f} "
                                f"must be within +-{mean}")
    return dict(iteration_gaps=signed, median_gap=mid, mean_gap=avg)


def run_cli(argv):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import solve

    reset_launch_counts()
    res = solve.main(argv)
    return res, launch_counts()


def expected_counts(iters: int, batched: bool = False) -> dict:
    """Every kernel's launches over a fused solve of ``iters`` iterations:
    2 stencils and 1 of each pass per iteration, 2 more dots at setup, and
    none of the other form or of K6."""
    sfx = "_batched" if batched else ""
    counts = {k: 0 for k in KERNELS}
    counts.update({"stencil_nd" + sfx: 2 * iters, "update_q_dots" + sfx: iters,
                   "update_xr_dots" + sfx: iters, "update_p" + sfx: iters,
                   "dot_mixed" + sfx: iters + 2})
    return counts


def with_spmd_dots(op):
    """The fused operator with every dot partial taken as the spmd backend
    takes it (``Policy.dot``), in the fused passes and in ``op.dots`` (the
    generic loops' dots): the kernels' vector outputs stay, only the dots'
    summation order changes."""
    from repro_torch.core.operator import FusedOps

    d, f = op.policy.dot, op.fused

    def update_q_dots(alpha, r, s, y):
        q = f.update_q_dots(alpha, r, s, y)[0]
        return q, d(q, y), d(y, y)

    def update_xr_dots(alpha, omega, x, p, q, y, r0):
        x, r = f.update_xr_dots(alpha, omega, x, p, q, y, r0)[:2]
        return x, r, d(r0, r), d(r, r)

    return dataclasses.replace(
        op, dots=lambda pairs, policy: op.reduce_partials([policy.dot(a, b) for a, b in pairs]),
        fused=FusedOps(dot_partial=d, update_q_dots=update_q_dots,
                       update_xr_dots=update_xr_dots, update_p=f.update_p))


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


def batched_semantics(torch, seed: int) -> dict:
    """The default cell with 4 right-hand sides through the fused kernels:
    every RHS converges, equals its unbatched solve bit for bit, and a
    (1,)+shape batch equals the unbatched solve bit for bit."""
    from repro_torch.core import bicgstab, precision, stencil
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import solve
    from repro_torch.launch.mesh import make_mesh_for_devices

    _, cf, b = solve.manufactured_system(None, stencil.STAR7, DEFAULT_MESH, seed=seed,
                                         device=torch.device("cuda"), nrhs=MAIN_NRHS)
    mesh = make_mesh_for_devices()
    kw = dict(tol=1e-6, maxiter=200, policy=precision.F32, backend="fused")
    reset_launch_counts()
    rb = bicgstab.solve_distributed(mesh, cf, b, **kw)
    counts = launch_counts()
    its = rb.iterations.tolist()
    out = dict(seed=seed, iterations=its, converged=rb.converged.tolist(),
               true_rel_residual=[solve._true_rel_residual(cf, rb.x[i], b[i])
                                  for i in range(MAIN_NRHS)], launches=counts)
    check(counts == expected_counts(max(its), batched=True),
          f"seed {seed}: batched launch counts {counts}")
    check(all(out["converged"]) and max(out["true_rel_residual"]) < 1e-5,
          f"seed {seed}: batched solve converged {out['converged']}, true rel-residuals "
          f"{out['true_rel_residual']}")
    solo = [bicgstab.solve_distributed(mesh, cf, b[i], **kw) for i in range(MAIN_NRHS)]
    out["solo_iterations"] = [int(r.iterations) for r in solo]
    out["per_rhs_bitwise"] = [bool(rb.x[i].equal(r.x)) and its[i] == int(r.iterations)
                              and bool(rb.rel_residual[i].equal(r.rel_residual))
                              for i, r in enumerate(solo)]
    check(all(out["per_rhs_bitwise"]),
          f"seed {seed}: batched RHS not bitwise their solo solves {out['per_rhs_bitwise']}")
    r1 = bicgstab.solve_distributed(mesh, cf, b[:1], **kw)
    out["b1_bitwise"] = (bool(r1.x[0].equal(solo[0].x))
                         and int(r1.iterations[0]) == int(solo[0].iterations))
    check(out["b1_bitwise"], f"seed {seed}: a (1,)+shape solve is not the unbatched one")
    return out


def ref_fused_default(torch, seed: int, spmd_iterations: int, fused_iterations: int) -> dict:
    """solve_ref_fused at the default cell, f32, tol 1e-6: it must converge
    to a true relative residual below 1e-5; its count against spmd's goes to
    phase 7's gap rule, and the gap to the fused path is recorded beside it."""
    from repro_torch.core import bicgstab, stencil
    from repro_torch.launch import solve

    _, cf, b = solve.manufactured_system(None, stencil.STAR7, DEFAULT_MESH, seed=seed,
                                         device=torch.device("cuda"))
    res = bicgstab.solve_ref_fused(cf, b, tol=1e-6, maxiter=200)
    out = dict(seed=seed, iterations=int(res.iterations), converged=bool(res.converged),
               spmd_iterations=spmd_iterations, fused_iterations=fused_iterations,
               true_rel_residual=solve._true_rel_residual(cf, res.x, b))
    check(out["converged"] and out["true_rel_residual"] < 1e-5,
          f"seed {seed}: solve_ref_fused {out}")
    return out


def ref_fused_paper_mesh(torch, iters: int = MAIN_ITERS) -> tuple[dict, dict]:
    """solve_ref_fused at 608x608x1536 in bf16 (f32 SpMV accumulation) for
    ``iters`` iterations at tol 0; returns (result, launch counts)."""
    from repro_torch.core import bicgstab, stencil
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    cf = stencil.convection_diffusion(PAPER_MESH, device=dev)
    x = torch.randn(PAPER_MESH, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    b = stencil.rhs_for_solution(cf, x).to(torch.bfloat16)
    cf = cf.astype(torch.bfloat16)
    del x
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = bicgstab.solve_ref_fused(cf, b, tol=0.0, maxiter=iters)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    moved = ref_fused_iteration_bytes(PAPER_MESH, 2)
    ms = dt / max(int(res.iterations), 1) * 1e3
    out = dict(phase="ref_fused_paper_mesh", shape=list(PAPER_MESH), dtype="bfloat16",
               iterations=int(res.iterations), rel_residual=float(res.rel_residual),
               ms_per_iter=ms, bytes_per_iter=moved, gb_per_s=moved / (ms * 1e-3) / 1e9,
               bound_ms_per_iter=moved / PEAK_BYTES_PER_S * 1e3, launches=counts)
    want = {k: 0 for k in KERNELS}
    want.update(stencil7_dot=2 * iters, update_xr_dots=iters, update_p=iters)
    check(counts == want, f"solve_ref_fused launch counts {counts} != {want}")
    check(out["iterations"] == iters and math.isfinite(out["rel_residual"])
          and out["rel_residual"] < 1, f"solve_ref_fused at the paper mesh: {out}")
    return out, counts


# ---------------------------------------------------------------------------
# Phase 8: the solver and preconditioner stack
# ---------------------------------------------------------------------------

SLICE_MAXITER = 2000
CHEB_DEGREE = 3


class SlicePath(NamedTuple):
    """One path of phase 8 and the limits of its own checks.

    ``launches(n)`` gives (K1, K5, each of K2-K4) over a fused solve of n
    iterations from x0 = None, the setup's 2 dots included; a Chebyshev apply
    of degree d runs d - 1 stencils, so each wrapped SpMV costs d and the
    unwrap at the end d - 1."""

    solver: str
    problem: str
    precond: str
    tol: float                        #: 8a, f32
    launches: Callable[[int], tuple[int, int, int]]
    #: 8a: the true relative residual must fall below this multiple of tol
    residual_factor: float = 10
    #: 8a: the fused-spmd iteration gaps keep MEDIAN_GAP and EVERY_GAP
    #: (otherwise they are recorded)
    gap_rule: bool = False
    #: 8a: a flagged breakdown with finite residuals ends the solve as well
    may_break_down: bool = False
    #: 8a: at most this multiple of plain BiCGStab's iterations, both backends
    lever: float | None = None
    #: 8a: 4 RHS, each bit for bit its solo solve
    batched: bool = False
    #: 8b: the true relative residual must fall below this
    true_residual_max: float = 1
    #: 8b: the kernels with spmd-order dots must also give the plain solve
    #: of the same system bit for bit (:func:`plain_at_paper_mesh`)
    plain_at_paper_mesh: bool = False


#: the paths of phase 8 (solver, problem, preconditioner at the default cell and
#: at the paper mesh).  Pipelined CG runs at its f32 floor, tol 1e-5.  The
#: pipelined loops test a carried recurrence norm that drifts from the true
#: residual: over seeds 0-19 of the default cell on an H100
#: (scripts/iteration_gaps.py) the true residual read up to 10.0 x tol
#: (pipelined_cg) and 15.5 x (pipelined_bicgstab).  In bf16 pipelined CG's x
#: drifts from its recurrence residual, as the JAX package's does
#: (tests/test_torch_solvers.py::test_bf16_pipelined_cg_drifts_as_jax), by
#: an amount that no rounding order controls: at 608x608x1536, 30
#: iterations, seeds 0-2 on an H100 (scripts/pipelined_drift.py) its true
#: residual read 37.7, 0.31 and 0.87 through the kernels and 0.40, 2.0 and
#: 6.2 through the spmd backend, all with recurrence residuals of 0.036-0.27.
#: So at the paper mesh it is bounded by 100, and the kernels with
#: spmd-order dots must give the spmd solve bit for bit there.
#: f32 BiCGStab with Jacobi on the raw heterogeneous operator (couplings
#: spanning ~3e7) breaks down or stalls on some seeds in the JAX package too
#: (tests/test_torch_precond.py::test_jax_jacobi_also_fails_on_the_heterogeneous_family),
#: so a flagged breakdown ends that run; the fused kernels must still give
#: the plain solve bit for bit, breakdown included.
SLICE_PATHS = {
    "cg": SlicePath("cg", "poisson", "none", 1e-6, lambda n: (n, 2 * n + 2, 0),
                    gap_rule=True, batched=True),
    "pipelined_cg": SlicePath("pipelined_cg", "poisson", "none", 1e-5,
                              lambda n: (n + 1, 2 * n + 2, 0), residual_factor=20,
                              true_residual_max=100, plain_at_paper_mesh=True),
    "pipelined_bicgstab": SlicePath("pipelined_bicgstab", "convdiff", "none", 1e-6,
                                    lambda n: (2 * n + 2, 12 * n + 2, 0), residual_factor=20,
                                    batched=True),
    "chebyshev": SlicePath("bicgstab", "poisson", "chebyshev", 1e-6,
                           lambda n: (2 * CHEB_DEGREE * n + CHEB_DEGREE - 1, n + 2, n),
                           gap_rule=True, lever=0.7),
    "jacobi": SlicePath("bicgstab", "heterogeneous", "jacobi", 1e-6,
                        lambda n: (2 * n, n + 2, n), may_break_down=True),
}


def path_flags(path: SlicePath) -> list[str]:
    """The CLI flags that select ``path``."""
    return ["--solver", path.solver, "--problem", path.problem, "--precond", path.precond,
            "--cheb-degree", str(CHEB_DEGREE)]


def slice_counts(path: SlicePath, iters: int, batched: bool = False, dots: bool = True) -> dict:
    """Every kernel's launches over a fused solve of ``path`` that ran
    ``iters`` iterations from x0 = None.  ``dots=False``: the dots were taken
    in the spmd order, so no ``dot_mixed`` ran."""
    k1, k5, passes = path.launches(iters)
    sfx = "_batched" if batched else ""
    counts = {k: 0 for k in KERNELS}
    counts.update({"stencil_nd" + sfx: k1, "dot_mixed" + sfx: k5 if dots else 0})
    for name in ("update_q_dots", "update_xr_dots", "update_p"):
        counts[name + sfx] = passes
    return counts


def slice_iteration_bytes(label: str, shape, itemsize: int) -> int:
    """Bytes one iteration of path ``label`` must move in ``bf16_mixed``
    (every vector in the storage dtype): each statement's tensor inputs read
    once and its output written once, as :func:`iteration_bytes` counts.  An
    SpMV is the zero pad and the stencil kernel; a dot reads 2 words, an
    AXPY 2 and writes 1, ``axpy2`` reads 3.  Preconditioned BiCGStab is the
    fused iteration (20 words beside its SpMVs) with each SpMV wrapped:
    Chebyshev adds d - 1 SpMVs and 2 + 9 (d - 1) words (``r * 1/theta``,
    then per step ``r - Ad``, ``a d + b r``, ``z + d``), Jacobi 3 words
    (``v * 1/diag``) and the raw diagonal's ``u + (d - 1) v``, 4."""
    n = math.prod(shape)
    n_pad = math.prod(s + 2 for s in shape)
    spmv = (n + n_pad) + (n_pad + 6 * n + n)
    d = CHEB_DEGREE
    words = {
        "cg": spmv + (2 * 2 + 3 * 3) * n,
        "pipelined_cg": spmv + (2 * 2 + 6 * 3) * n,
        "pipelined_bicgstab": 2 * spmv + (12 * 2 + 7 * 3 + 4) * n,
        "chebyshev": 2 * (d * spmv + (2 + 9 * (d - 1)) * n) + 20 * n,
        "jacobi": 2 * (spmv + 7 * n) + 20 * n,
    }[label]
    return words * itemsize


def run_cli_quiet(argv):
    """``run_cli`` with the CLI's own lines kept off the output."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return run_cli(argv)


def converged_within(res: dict, path: SlicePath) -> bool:
    """The solve converged to a true relative residual below
    ``path.residual_factor`` x tol, or (``path.may_break_down``) stopped at
    a flagged breakdown with a finite residual."""
    if res["converged"] and res["true_rel_residual"] < path.residual_factor * path.tol:
        return True
    return path.may_break_down and res["breakdown"] and math.isfinite(res["rel_residual"])


def spmd_split(cf, policy):
    """The spmd operator with a raw main diagonal split as the fused operator
    splits it: the unit-diagonal halo apply, then ``(d - 1) v`` added in the
    compute dtype, plain tensor ops throughout.  On a unit-diagonal operator
    it is the spmd operator."""
    from repro_torch.core.operator import make_operator
    from repro_torch.core.stencil import StencilCoeffs

    if cf.diag is None:
        return make_operator("spmd", cf, policy=policy)
    unit = make_operator("spmd", StencilCoeffs(cf.diags), policy=policy)
    c, raw = policy.compute, cf.astype(policy.storage)
    dcorr = raw.diag.to(c) - 1

    def apply(v):
        return (unit.apply(v).to(c) + dcorr * v.to(c)).to(policy.storage)

    return dataclasses.replace(unit, coeffs=raw, apply=apply)


def slice_semantics(torch, label: str, seed: int) -> dict:
    """Path ``label`` at the default cell through the CLI's fused path and
    the spmd backend, each held to the path's limits; the fused kernels with
    spmd-order dots against :func:`spmd_split`, bit for bit; on a raw
    diagonal, the fused SpMV against spmd's; with a lever, plain BiCGStab on
    the same system, on both backends."""
    from repro_torch.core import precision, stencil
    from repro_torch.core.operator import make_operator
    from repro_torch.core.precond import PrecondConfig, build_precond
    from repro_torch.core.solvers import get_solver
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import solve

    path = SLICE_PATHS[label]
    tol = path.tol
    fused, counts = run_cli_quiet(["--backend", "fused", "--policy", "f32", "--seed", str(seed),
                                   *path_flags(path), "--tol", str(tol),
                                   "--maxiter", str(SLICE_MAXITER)])
    _, cf, b = solve.manufactured_system(path.problem, stencil.STAR7, DEFAULT_MESH, seed=seed,
                                         device=torch.device("cuda"))
    f32 = precision.F32

    def direct(op, pc=path.precond):
        m = build_precond(PrecondConfig(name=pc, degree=CHEB_DEGREE), op)
        return get_solver(path.solver)(op, b, None, tol=tol, maxiter=SLICE_MAXITER, policy=f32,
                                       precond=m)

    spmd = direct(make_operator("spmd", cf, policy=f32))
    sp = dict(converged=bool(spmd.converged), breakdown=bool(spmd.breakdown),
              rel_residual=float(spmd.rel_residual),
              true_rel_residual=solve._true_rel_residual(cf, spmd.x, b))
    out = dict(seed=seed, iterations=fused["iterations"], spmd_iterations=int(spmd.iterations),
               converged=fused["converged"], breakdown=fused["breakdown"],
               true_rel_residual=fused["true_rel_residual"],
               spmd_converged=sp["converged"], spmd_breakdown=sp["breakdown"],
               spmd_true_rel_residual=sp["true_rel_residual"], launches=counts)
    check(converged_within(fused, path) and converged_within(sp, path),
          f"{label} seed {seed}: fused {fused['converged']}/{fused['true_rel_residual']:.3e}, "
          f"spmd {sp['converged']}/{sp['true_rel_residual']:.3e} against tol {tol}")
    check(counts == slice_counts(path, fused["iterations"]),
          f"{label} seed {seed}: launch counts {counts}")
    plain = spmd if cf.diag is None else direct(spmd_split(cf, f32))
    reset_launch_counts()
    var = direct(with_spmd_dots(make_operator("fused", cf, policy=f32)))
    counts_sd = launch_counts()
    it = int(var.iterations)
    out.update(spmd_order_iterations=it, spmd_split_iterations=int(plain.iterations),
               spmd_order_bitwise=(bool(var.x.equal(plain.x)) and it == int(plain.iterations)
                                   and bool(var.breakdown) == bool(plain.breakdown)))
    check(out["spmd_order_bitwise"],
          f"{label} seed {seed}: fused with spmd-order dots ({it} iterations) is not the "
          f"plain solve ({int(plain.iterations)}) bit for bit")
    check(counts_sd == slice_counts(path, it, dots=False),
          f"{label} seed {seed}: spmd-order-dot launch counts {counts_sd}")
    if cf.diag is not None:
        out["apply_err_over_scale"] = raw_diag_apply_err(torch, cf, seed)
        check(out["apply_err_over_scale"] <= 8 * EPS_F32,
              f"{label} seed {seed}: the fused apply is {out['apply_err_over_scale']:.3e} of its "
              f"terms' scale from spmd's")
    if path.lever is not None:
        out["plain_iterations"] = int(direct(make_operator("fused", cf, policy=f32),
                                             pc="none").iterations)
        out["plain_spmd_iterations"] = int(direct(make_operator("spmd", cf, policy=f32),
                                                  pc="none").iterations)
        check(out["iterations"] <= path.lever * out["plain_iterations"]
              and out["spmd_iterations"] <= path.lever * out["plain_spmd_iterations"],
              f"{label} seed {seed}: {out['iterations']}/{out['spmd_iterations']} iterations "
              f"against plain BiCGStab's {out['plain_iterations']}/"
              f"{out['plain_spmd_iterations']}")
    return out


def raw_diag_apply_err(torch, cf, seed: int) -> float:
    """The SpMV of a raw-diagonal operator on a Jacobi-preconditioned vector
    u = D^-1 v, fused (the unit-diagonal kernel plus the raw diagonal's
    (d - 1) u, plain ops) against spmd's (d u plus the neighbours): the
    largest difference over the scale of each row's terms,
    (1 + |d| + |d - 1|) |u| + sum |c| |u_nb|.  Both round each op to f32, in
    other orders, so a few f32 epsilons."""
    from repro_torch.core import precision, stencil
    from repro_torch.core.operator import make_operator
    from repro_torch.core.precond import PrecondConfig, build_precond

    dev = torch.device("cuda")
    f32 = precision.F32
    spmd = make_operator("spmd", cf, policy=f32)
    v = torch.randn(cf.shape, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    u = build_precond(PrecondConfig(name="jacobi"), spmd).apply(v)
    d = cf.diag
    scale = stencil.apply_ref(stencil.StencilCoeffs({n: c.abs() for n, c in cf.diags.items()},
                                                    diag=1 + d.abs() + (d - 1).abs()), u.abs())
    diff = make_operator("fused", cf, policy=f32).apply(u) - spmd.apply(u)
    return float((diff.abs() / scale).max())


def slice_batched(torch, label: str, seed: int) -> dict:
    """Path ``label`` with 4 RHS at the default cell through the batched
    kernels: each RHS's x and count equal its solo fused solve bit for bit."""
    from repro_torch.core import bicgstab, precision, stencil
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import solve
    from repro_torch.launch.mesh import make_mesh_for_devices

    path = SLICE_PATHS[label]
    _, cf, b = solve.manufactured_system(path.problem, stencil.STAR7, DEFAULT_MESH, seed=seed,
                                         device=torch.device("cuda"), nrhs=MAIN_NRHS)
    mesh = make_mesh_for_devices()
    kw = dict(tol=path.tol, maxiter=SLICE_MAXITER, policy=precision.F32, solver=path.solver,
              backend="fused")
    reset_launch_counts()
    rb = bicgstab.solve_distributed(mesh, cf, b, **kw)
    counts = launch_counts()
    its = rb.iterations.tolist()
    solo = [bicgstab.solve_distributed(mesh, cf, b[i], **kw) for i in range(MAIN_NRHS)]
    out = dict(path=label, seed=seed, iterations=its, converged=rb.converged.tolist(),
               solo_iterations=[int(r.iterations) for r in solo], launches=counts,
               per_rhs_bitwise=[bool(rb.x[i].equal(r.x)) and its[i] == int(r.iterations)
                                for i, r in enumerate(solo)])
    check(all(out["converged"]), f"{label} batched seed {seed}: converged {out['converged']}")
    check(all(out["per_rhs_bitwise"]),
          f"{label} batched seed {seed}: RHS not bitwise their solo solves {out}")
    check(counts == slice_counts(path, max(its), batched=True),
          f"{label} batched seed {seed}: launch counts {counts}")
    return out


def iteration_fn_first_step(torch) -> dict:
    """``make_iteration_fn(backend="fused")`` called on the fused loop's
    initial state (the default cell, f32, seed 0) against the loop's first
    step, read by wrapping the loop's ``run_krylov``: all five outputs bit
    for bit."""
    from repro_torch.core import bicgstab, precision, stencil
    from repro_torch.core.operator import make_operator
    from repro_torch.core.solvers import bicgstab as loops
    from repro_torch.launch import solve
    from repro_torch.launch.mesh import make_mesh_for_devices

    _, cf, b = solve.manufactured_system(None, stencil.STAR7, DEFAULT_MESH, seed=0,
                                         device=torch.device("cuda"))
    op = make_operator("fused", cf, policy=precision.F32)
    seen, real = {}, loops.run_krylov

    def spy(step, init, **kw):
        seen["init"], seen["step"] = init, step(init)
        return real(step, init, **kw)

    loops.run_krylov = spy
    try:
        loops.bicgstab_fused_loop(op, b, None, tol=0.0, maxiter=1, policy=precision.F32)
    finally:
        loops.run_krylov = real
    _, x0, r0, p0, rho0, *_ = seen["init"]
    it = bicgstab.make_iteration_fn(make_mesh_for_devices(), policy=precision.F32,
                                    backend="fused")
    got = it(op.coeffs, x0, r0, p0, r0, rho0)
    same = [bool(g.equal(w)) for g, w in zip(got, seen["step"][1:6])]
    check(len(same) == 5 and all(same),
          f"make_iteration_fn's first call is not the fused loop's first step: {same}")
    return dict(outputs_bitwise=same)


def slice_full_width(torch, label: str, smi: str) -> dict:
    """Path ``label`` at 608x608x1536, ``bf16_mixed``, through the CLI's
    fused path for 30 iterations at tol 0."""
    path = SLICE_PATHS[label]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts = run_cli(["--mesh", *(str(s) for s in PAPER_MESH), "--backend", "fused",
                           "--policy", "bf16_mixed", "--tol", "0", "--maxiter", str(MAIN_ITERS),
                           *path_flags(path)])
    moved = slice_iteration_bytes(label, PAPER_MESH, 2)
    res.update(phase="slice_full_width", path=label, card=smi, bytes_per_iter=moved,
               gb_per_s=moved / (res["ms_per_iter"] * 1e-3) / 1e9,
               bound_ms_per_iter=moved / PEAK_BYTES_PER_S * 1e3,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
               launches_per_iter={k: v / MAIN_ITERS for k, v in counts.items() if v})
    resid = (res["rel_residual"], res["true_rel_residual"])
    check(all(math.isfinite(v) for v in resid) and res["rel_residual"] < 1
          and res["true_rel_residual"] < path.true_residual_max,
          f"{label} at the paper mesh: residuals {resid}")
    check(res["iterations"] == MAIN_ITERS and not res["breakdown"],
          f"{label} at the paper mesh ran {res['iterations']} iterations "
          f"(breakdown {res['breakdown']})")
    check(counts == slice_counts(path, MAIN_ITERS),
          f"{label} at the paper mesh: launch counts {counts}")
    if path.plain_at_paper_mesh:
        res["plain"] = plain_at_paper_mesh(torch, label)
    return res


def plain_at_paper_mesh(torch, label: str) -> dict:
    """The CLI's system of path ``label`` (seed 0) at 608x608x1536,
    ``bf16_mixed``, 30 iterations at tol 0: the fused kernels with
    spmd-order dots against the plain solve (:func:`spmd_split`), x bit for
    bit; recorded beside it, the plain solve's residuals, and whether the
    solve with K5's plain version as its dots gives the kernels' x."""
    from repro_torch.core import precision, stencil
    from repro_torch.core.operator import make_operator
    from repro_torch.core.precond import PrecondConfig, build_precond
    from repro_torch.core.solvers import get_solver
    from repro_torch.kernels.fused_iter.ref import dot_mixed_ref
    from repro_torch.launch import solve

    path, mixed = SLICE_PATHS[label], precision.MIXED
    torch.cuda.empty_cache()
    _, cf, b = solve.manufactured_system(path.problem, stencil.STAR7, PAPER_MESH, seed=0,
                                         device=torch.device("cuda"), solver=path.solver)

    def run(op):
        m = build_precond(PrecondConfig(name=path.precond, degree=CHEB_DEGREE), op)
        return get_solver(path.solver)(op, b, None, tol=0.0, maxiter=MAIN_ITERS, policy=mixed,
                                       precond=m)

    plain_op = spmd_split(cf, mixed)
    plain = run(plain_op)
    var = run(with_spmd_dots(make_operator("fused", cf, policy=mixed)))
    out = dict(rel_residual=float(plain.rel_residual),
               true_rel_residual=solve._true_rel_residual(cf, plain.x, b),
               spmd_order_bitwise=bool(var.x.equal(plain.x)))
    del var
    check(out["spmd_order_bitwise"],
          f"{label} at the paper mesh: the kernels with spmd-order dots are not the plain solve")
    fused = run(make_operator("fused", cf, policy=mixed))
    k5 = run(dataclasses.replace(plain_op, dots=lambda pairs, p: plain_op.reduce_partials(
        [dot_mixed_ref(a, c) for a, c in pairs])))
    out["k5_plain_dots_bitwise"] = bool(fused.x.equal(k5.x))
    del cf, b, plain, fused, k5
    torch.cuda.empty_cache()
    return out


def time_iteration_fn(torch, smi: str, phase4_ms: float) -> dict:
    """One ``make_iteration_fn(backend="fused")`` call at the paper mesh in
    ``bf16_mixed`` (CUDA events, mean of 5 after 1 warm-up), beside phase
    4's ms/iter, with its launch counts and the iteration's bytes bound."""
    from repro_torch.core import bicgstab, precision, stencil
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_mesh_for_devices

    dev, mixed = torch.device("cuda"), precision.MIXED
    torch.cuda.empty_cache()
    cf = stencil.convection_diffusion(PAPER_MESH, device=dev).astype(torch.bfloat16)
    r = torch.randn(PAPER_MESH, generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev).to(torch.bfloat16)
    x, rho = torch.zeros_like(r), mixed.dot(r, r)
    it = bicgstab.make_iteration_fn(make_mesh_for_devices(), policy=mixed, backend="fused")
    reset_launch_counts()
    it(cf, x, r, r, r, rho)
    counts = launch_counts()
    ms = cuda_ms(torch, lambda: it(cf, x, r, r, r, rho), n=5, warmup=1)
    moved = iteration_bytes(PAPER_MESH, 2)
    want = dict(expected_counts(1), dot_mixed=1)
    check(counts == want, f"make_iteration_fn launch counts {counts} != {want}")
    del cf, r, x
    torch.cuda.empty_cache()
    return dict(phase="iteration_fn", card=smi, shape=list(PAPER_MESH), dtype="bfloat16",
                ms=ms, phase4_ms_per_iter=phase4_ms, bytes=moved,
                bound_ms=moved / PEAK_BYTES_PER_S * 1e3, launches=counts)


def draw_check(torch) -> dict:
    """8c: at the default cell, seeds 0-4, the default, heterogeneous and
    random problems: the coefficients and x_true drawn for the card equal
    those drawn for the CPU bit for bit; whether ``b = A x_true`` does too is
    recorded."""
    from repro_torch.core import stencil
    from repro_torch.launch import solve

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rows = []
    for seed in range(PHASE3_SEEDS):
        for problem in (None, "heterogeneous", "random"):
            drawn = []
            for dev in (cuda, cpu):
                name, cf = solve.manufactured_problem(problem, stencil.STAR7, DEFAULT_MESH,
                                                      seed=seed, device=dev)
                x = solve.manufactured_solution(DEFAULT_MESH, seed=seed, device=dev)
                drawn.append((cf, x, stencil.rhs_for_solution(cf, x)))
            (cg, xg, bg), (cc, xc, bc) = drawn
            fields = lambda c: list(c.diags.values()) + ([] if c.diag is None else [c.diag])
            row = dict(seed=seed, problem=name,
                       coeffs_equal=(cg.names == cc.names and (cg.diag is None) == (cc.diag is None)
                                     and all(g.cpu().equal(c) for g, c in
                                             zip(fields(cg), fields(cc)))),
                       x_true_equal=bool(xg.cpu().equal(xc)), b_equal=bool(bg.cpu().equal(bc)))
            check(row["coeffs_equal"] and row["x_true_equal"],
                  f"seed {seed} {name}: the card's draw is not the CPU's {row}")
            rows.append(row)
    return dict(phase="draw_check", runs=rows, b_equal_all=all(r["b_equal"] for r in rows))


def phase8(torch, smi: str, phase4_ms: float) -> dict:
    """8a at the default cell, 8b at the paper mesh, 8c the draw check."""
    out: dict = {}
    for label, path in SLICE_PATHS.items():
        runs = [slice_semantics(torch, label, seed) for seed in range(PHASE3_SEEDS)]
        signed = [r["iterations"] - r["spmd_iterations"] for r in runs]
        gaps = (gap_check(f"{label} fused vs spmd", signed, EVERY_GAP, median=MEDIAN_GAP)
                if path.gap_rule else dict(iteration_gaps=signed))
        out[label] = dict(runs=runs, **gaps)
        emit(dict(phase="slice_default", path=label, card=smi, **out[label]))
    refine = []
    for seed in range(PHASE3_SEEDS):
        res, counts = run_cli_quiet(["--refine", "--policy", "bf16_mixed", "--seed", str(seed)])
        rels = res["refine_rel_residuals"]
        refine.append(dict(seed=seed, trajectory=rels, max_err=res["max_err"], launches=counts))
        check(all(a > b for a, b in zip(rels, rels[1:])) and rels[-1] < 1e-5,
              f"--refine seed {seed}: trajectory {rels}")
        check(not any(counts.values()), f"--refine seed {seed} launched kernels {counts}")
    out["refine"] = refine
    emit(dict(phase="slice_refine", card=smi, runs=refine))
    out["batched"] = [slice_batched(torch, label, seed) for label, path in SLICE_PATHS.items()
                      if path.batched for seed in range(PHASE3_SEEDS)]
    emit(dict(phase="slice_batched", card=smi, runs=out["batched"]))
    out["iteration_fn_first_step"] = iteration_fn_first_step(torch)
    emit(dict(phase="slice_iteration_fn_first_step", **out["iteration_fn_first_step"]))
    out["full_width"] = {}
    for label in SLICE_PATHS:
        out["full_width"][label] = slice_full_width(torch, label, smi)
        emit(out["full_width"][label])
    out["iteration_fn"] = time_iteration_fn(torch, smi, phase4_ms)
    emit(out["iteration_fn"])
    out["draw_check"] = draw_check(torch)
    emit(out["draw_check"])
    return out


# ---------------------------------------------------------------------------
# Phase 9: the tuning cache, observability and the performance model
# ---------------------------------------------------------------------------

#: 9a's sweeps: (label, block, right-hand sides)
SWEEP_CELLS = (("cs1_paper", PAPER_MESH, 1), ("joule_600", JOULE_MESH, MAIN_NRHS))
#: the spans 9b's trace.json must hold
OBS_SPANS = {"solve.krylov", "operator.build", "comm.halo.issue", "comm.halo.interior",
             "comm.halo.ring"}
STENCIL_KERNEL = "stencil_nd_kernel"


def sweep_cell(torch, label: str, shape, nrhs: int) -> dict:
    """9a: sweep one cell into the active cache; one line per candidate."""
    from repro_torch.core import stencil, tuning

    torch.cuda.empty_cache()
    try:
        rec = tuning.autotune_cell(stencil.STAR7, torch.bfloat16, shape, nrhs=nrhs,
                                   device="cuda")
    except RuntimeError as e:        # a candidate changed a bit
        check(False, f"9a {label}: {e}")
        return dict(cell=label, error=str(e))
    torch.cuda.empty_cache()
    rows = [dict(config=r["config"], ms=r["seconds"] * 1e3, bound_ms=rec["bound_s"] * 1e3,
                 bound_share=r["bound_share"], bitwise_default=r["bitwise_default"])
            for r in rec["swept"]]
    for row in rows:
        c = row["config"]
        emit(f"9a {label} x{nrhs}: seg_len {c['seg_len']:4d} chunk {c['chunk']} "
             f"fuse_ring {c['fuse_ring']!s:5}: {row['ms']:.3f} ms, bound {row['bound_ms']:.3f} "
             f"ms, {row['bound_share']:.1%} of it; {rec['card']}")
    check(not rec["cache_hit"] and rec["fabric"] == [1, 1, 1]
          and all(r["bitwise_default"] and not r["config"]["fuse_ring"] for r in rows),
          f"9a {label}: the sweep did not hold every plan to the default on one rank")
    ring = ring_forms_agree(torch, shape, nrhs, [r["config"] for r in rows])
    return dict(cell=label, key=rec["key"], card=rec["card"], nrhs=nrhs, shape=list(shape),
                winner=rec["config"], default=rec["default_config"],
                speedup_vs_default=rec["speedup_vs_default"], bound_ms=rec["bound_s"] * 1e3,
                ring_forms_bitwise=ring, rows=rows)


def ring_forms_agree(torch, shape, nrhs: int, configs: list[dict]) -> bool:
    """9a: on a synthetic 2x2 exchange, each plan's fused ring form and its
    split form (kernel on the zero-padded block, then four slab patches)
    equal the default's split form bit for bit."""
    import dataclasses

    from repro_torch.core import stencil, tuning

    spec = stencil.STAR7
    problem = tuning.cell_problem(spec, torch.bfloat16, shape, nrhs=nrhs, device="cuda",
                                  fabric=tuning.RING_FABRIC)
    want = tuning.config_apply(problem, spec, tuning.KernelConfig.from_json(configs[0]))
    ok = True
    for c in configs:
        cfg = tuning.KernelConfig.from_json(c)
        for fuse in (False, True):
            got = tuning.config_apply(problem, spec, dataclasses.replace(cfg, fuse_ring=fuse))
            ok = ok and torch.equal(got.view(torch.int16), want.view(torch.int16))
            del got
    del problem, want
    torch.cuda.empty_cache()
    check(ok, f"9a {shape} x{nrhs}: a plan's fused and split ring forms differ on the 2x2 "
              f"exchange")
    return ok


def same_run(label: str, res: dict, counts: dict, phase4: dict) -> None:
    """The residuals and launch counts of a phase-9 CLI run equal phase 4's."""
    for k in ("iterations", "rel_residual", "true_rel_residual"):
        check(res[k] == phase4[k], f"{label}: {k} {res[k]!r} != phase 4's {phase4[k]!r}")
    check(counts == phase4["launches"],
          f"{label}: launch counts {counts} != phase 4's {phase4['launches']}")


def read_jsonl(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def phase9(torch, smi: str, phase4: dict) -> dict:
    """9a the sweep and the ``--autotune`` solve, 9b the ``--obs`` bundle,
    9c the ``--profile`` trace, 9d the model (module docstring)."""
    import os
    import shutil
    import tempfile

    from repro_torch.core import perfmodel, tuning
    from repro_torch.obs import manifest, trace

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_phase9_"))
    mesh = ["--mesh", *(str(s) for s in PAPER_MESH), "--backend", "fused", "--policy",
            "bf16_mixed", "--tol", "0", "--maxiter", str(MAIN_ITERS)]
    out: dict = {}
    try:
        # -- 9a: the sweep, then the CLI on the swept entry ---------------------
        os.environ[tuning.ENV_VAR] = str(tmp / "tuning_cache_torch.json")
        out["sweeps"] = [sweep_cell(torch, *cell) for cell in SWEEP_CELLS]
        emit(dict(phase="autotune_sweep", card=smi,
                  cells=[{k: v for k, v in c.items() if k != "rows"} for c in out["sweeps"]]))
        torch.cuda.empty_cache()
        res, counts = run_cli(mesh + ["--autotune"])
        hit = res.get("autotune", {}).get("cache_hit", False)
        check(hit, "9a: the --autotune solve did not hit the sweep's cache entry")
        same_run("9a --autotune", res, counts, phase4)
        out["autotune_solve"] = dict(cache_hit=hit, config=res.get("autotune", {}).get("config"),
                                     ms_per_iter=res["ms_per_iter"],
                                     rel_residual=res["rel_residual"], launches=counts)
        emit(dict(phase="autotune_solve", card=smi, phase4_ms_per_iter=phase4["ms_per_iter"],
                  **out["autotune_solve"]))

        # -- 9b: the --obs bundle, on phase 4's plan -----------------------------
        os.environ[tuning.ENV_VAR] = "off"
        torch.cuda.empty_cache()
        run_dir = tmp / "obs"
        res, counts = run_cli(mesh + ["--obs", "--run-dir", str(run_dir)])
        man = manifest.load_manifest(str(run_dir))
        problems = manifest.validate_manifest(man)
        dev = man["devices"]
        check(not problems, f"9b: manifest problems {problems}")
        check(torch.cuda.get_device_name(0) in dev["kinds"] and dev["power_limit"]
              and smi in (dev["nvidia_smi"] or []), f"9b: manifest devices {dev}")
        events = read_jsonl(run_dir / "events.jsonl")
        solves = [e for e in events if e["event"] == "solve"]
        colls = [e for e in events if e["event"] == "collectives"]
        check(len(solves) == 1 and solves[0]["iterations"] == [MAIN_ITERS],
              f"9b: solve events {solves}")
        check(len(colls) == 1 and colls[0]["allreduce_total"] == 1 + 3 * MAIN_ITERS
              and colls[0]["ppermute_total"] == 0, f"9b: collectives events {colls}")
        spans = {e["name"] for e in json.loads((run_dir / "trace.json").read_text())[
            "traceEvents"]}
        check(OBS_SPANS <= spans, f"9b: trace.json lacks spans {sorted(OBS_SPANS - spans)}")
        same_run("9b --obs", res, counts, phase4)
        out["obs"] = dict(ms_per_iter=res["ms_per_iter"], phase4_ms_per_iter=phase4["ms_per_iter"],
                          collectives=colls[0] if colls else None, spans=sorted(spans),
                          devices=dev, manifest_problems=problems,
                          launch_gauges={k: v for k, v in man["metrics"]["gauges"].items()
                                         if k.startswith("kernels.") and v})
        emit(dict(phase="obs_bundle", card=smi, **out["obs"]))

        # -- 9c: the --profile trace ---------------------------------------------
        torch.cuda.empty_cache()
        run_dir = tmp / "profile"
        try:
            res, counts = run_cli(mesh[:-1] + [str(PROFILE_ITERS), "--profile", "--run-dir",
                                               str(run_dir)])
        except RuntimeError as e:    # the profile recorded no device activity
            check(False, f"9c: {e}")
            return out
        trace_file = run_dir / manifest.PROFILE_DIR / trace.PROFILE_TRACE
        doc = json.loads(trace_file.read_text())
        kernels = [e for e in doc.get("traceEvents", [])
                   if str(e.get("cat", "")).lower() == "kernel"]
        stencil_events = [e for e in kernels if STENCIL_KERNEL in e.get("name", "")]
        check(len(stencil_events) >= 2 * PROFILE_ITERS,
              f"9c: the profile holds {len(stencil_events)} stencil kernel events "
              f"(of {len(kernels)} device kernels); want {2 * PROFILE_ITERS}")
        out["profile"] = dict(iterations=PROFILE_ITERS, trace_bytes=trace_file.stat().st_size,
                              device_kernel_events=len(kernels),
                              stencil_kernel_events=len(stencil_events),
                              stencil_kernel_us=sum(e.get("dur", 0) for e in stencil_events),
                              launches=counts)
        emit(dict(phase="profile_bundle", card=smi, **out["profile"]))
    finally:
        os.environ.pop(tuning.ENV_VAR, None)
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 9d: the model against the measurement -----------------------------------
    model = perfmodel.iteration_time_model(PAPER_MESH, 1)
    fused = perfmodel.iteration_time_model(PAPER_MESH, 1, fused_sweeps=True)
    out["model"] = dict(model_ms=model["t_iter_s"] * 1e3, model_bound=model["bound"],
                        model_fused_sweeps_ms=fused["t_iter_s"] * 1e3,
                        bytes_bound_ms=iteration_bytes(PAPER_MESH, 2) / PEAK_BYTES_PER_S * 1e3,
                        measured_ms=phase4["ms_per_iter"])
    emit(dict(phase="perfmodel", card=smi, shape=list(PAPER_MESH), **out["model"]))
    return out


# ---------------------------------------------------------------------------
# Phase 10: the SIMPLE CFD application (2D fields: no kernel on its path)
# ---------------------------------------------------------------------------

#: the CLI's steady limits, as the reference's Ghia run takes them
CFD_STEADY = ["--outer", "400", "--tol", "5e-6"]
CFD_BF16_OUTERS = 50
#: 10c: the transient march, its checkpoints and the injected fault
CFD_TRANSIENT_N, CFD_FAULT_STEP = 1024, 3
#: 10d: the full-size cavity, f32 and bf16_mixed
CFD_FULL_N, CFD_BF16_N, CFD_FULL_OUTERS, CFD_SHARE_REPS = 8192, 4096, 10, 3


def cell_flags(name: str) -> list[str]:
    """The CLI flags of a ``configs/cfd_scenarios.py`` cell."""
    from repro_torch.configs.cfd_scenarios import CFD_CELLS

    c = CFD_CELLS[name]
    flags = ["--scenario", c.scenario, "--n", str(c.n), "--re", str(c.reynolds),
             "--solver", c.solver, "--backend", c.backend, "--precond", c.precond,
             "--policy", c.policy, "--schedule", c.schedule]
    if not c.normalize:
        flags.append("--raw-coeffs")
    if c.p_solver:
        flags += ["--p-solver", c.p_solver]
    return flags


def run_cfd_quiet(argv: list[str], device: str = "cuda") -> dict:
    """``python -m repro_torch.launch.cfd argv --device device`` in this
    process, its lines kept off the output; a run that exits (a failed Ghia
    check) is a failure and gives ``{}``."""
    import contextlib
    import io

    from repro_torch.launch import cfd

    argv = argv + ["--device", device]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return cfd.main(argv)
    except SystemExit as e:
        check(False, f"10: cfd {' '.join(argv)} exited {e.code}: {buf.getvalue()[-800:]}")
        return {}


def cavity_fields(torch, res: dict) -> dict:
    """The converged cavity's own checks (``tests/test_cfd.py``): the largest
    divergence of the staggered field and the largest wall-face velocity."""
    from repro_torch.apps.cfd import to_staggered

    u, v, _ = res["state"]
    us, vs = to_staggered(u, v)
    div = (us[1:, :] - us[:-1, :] + vs[:, 1:] - vs[:, :-1]) * (1.0 / u.shape[0])
    walls = torch.stack([us[0].abs().max(), us[-1].abs().max(),
                         vs[:, 0].abs().max(), vs[:, -1].abs().max()])
    return dict(max_div=float(div.abs().max()), max_wall=float(walls.max()))


def steady_summary(res: dict) -> dict:
    return {k: res.get(k) for k in ("outer_iterations", "converged", "ghia_ok", "wall_s",
                                    "device", "policy", "precond", "p_solver")}


def bf16_diagonals(torch, state) -> dict:
    """min |diagonal| of the u, v and pressure systems formed from ``state``
    as raw rows in bf16 storage: the clamp-before-cast rule keeps each
    positive."""
    from repro_torch.apps.cfd import driver, grid, momentum, pressure
    from repro_torch.core import precision
    from repro_torch.core.halo import FabricAxes, gather_halo

    u, v, p = state
    n = u.shape[0]
    cfg = grid.CFDConfig(n=n, policy=precision.MIXED)
    fab = FabricAxes()
    gi, gj = grid.global_indices(n, (n, n), 0, 0, device=u.device)
    up, vp = gather_halo(u, fab, 1, corners=True), gather_halo(v, fab, 1, corners=True)
    pp = gather_halo(p, fab, 1)
    usys = momentum.form_u_system(cfg, up, vp, pp, u, u, gi, gj)
    vsys = momentum.form_v_system(cfg, up, vp, pp, v, v, gi, gj)
    div = pressure.divergence(cfg, u, v, gather_halo(u, fab, 1), gather_halo(v, fab, 1), gi)
    psys = pressure.form_pressure_system(cfg, usys[6], vsys[6], gather_halo(usys[6], fab, 1),
                                         gather_halo(vsys[6], fab, 1), div, gi, gj)
    raw = driver.SolverOptions(normalize=False)
    out = {}
    for name, rows in (("u", usys), ("v", vsys), ("p", psys)):
        cf, _ = driver._system_coeffs(raw, precision.MIXED, rows[:5], rows[5])
        out[name] = float(cf.diag.float().abs().min())
    return out


def cfd_transient(torch, smi: str) -> dict:
    """10c: the checkpointed cavity march with a fault at step 3 against the
    uninterrupted one, the card's checkpoint restored on the CPU, and the
    channel's outlet flux."""
    import shutil
    import tempfile

    from repro_torch.apps.cfd import CFDConfig, TransientConfig, run_transient
    from repro_torch.checkpoint import CheckpointManager

    cfg = CFDConfig(n=CFD_TRANSIENT_N, reynolds=100.0)
    tcfg = TransientConfig(dt=0.05, n_steps=6, outers_per_step=5, checkpoint_every=2)
    t0 = time.perf_counter()
    (u, v, p), ref_m = run_transient(cfg, tcfg, device="cuda")
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    armed = {"v": True}

    def hook(step):
        if step == CFD_FAULT_STEP and armed["v"]:
            armed["v"] = False
            raise RuntimeError("injected fault")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cfd_")
    try:
        state, metrics = run_transient(cfg, tcfg, checkpoint_dir=tmp, failure_hook=hook,
                                       device="cuda")
        like = (tuple(torch.zeros(cfg.n, cfg.n) for _ in range(3)), ())
        (restored, _), step = CheckpointManager(tmp).restore_latest(like)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    replay_equal = all(torch.equal(a, b) for a, b in zip(state, (u, v, p)))
    cpu_equal = all(torch.equal(a, b.cpu()) for a, b in zip(restored, state))
    check(not armed["v"], "10c: the fault was never injected")
    check([m["step"] for m in metrics] == list(range(tcfg.n_steps)) and metrics == ref_m,
          f"10c: replayed metrics {metrics} != {ref_m}")
    check(replay_equal, "10c: the replayed march differs from the uninterrupted one")
    check(step == tcfg.n_steps and cpu_equal,
          f"10c: the card's checkpoint (step {step}) restored on the CPU differs")
    ch_cfg = CFDConfig(n=CFD_TRANSIENT_N, reynolds=50.0, scenario="channel")
    (cu, _, _), ch_m = run_transient(ch_cfg, tcfg, device="cuda")
    outflux = float(cu[-1, :].sum() * (1.0 / ch_cfg.n))
    check(abs(outflux - ch_cfg.u_in) <= 1e-5, f"10c: channel outlet flux {outflux!r}")
    out = dict(n=cfg.n, dt=tcfg.dt, steps=tcfg.n_steps, outers_per_step=tcfg.outers_per_step,
               checkpoint_every=tcfg.checkpoint_every, fault_step=CFD_FAULT_STEP,
               replay_bitwise=replay_equal, cpu_restore_bitwise=cpu_equal,
               ms_per_step=t_ref / tcfg.n_steps * 1e3, final_continuity=ref_m[-1]["continuity"],
               channel_outflux=outflux, channel_continuity=ch_m[-1]["continuity"])
    emit(dict(phase="cfd_transient", card=smi, **out))
    return out


def cfd_full(torch, smi: str, n: int, policy: str, *, share: bool) -> dict:
    """10d: the steady cavity at n x n for a few outer iterations from rest
    (ms per outer iteration, peak memory), then (``share``) the paper's
    Table II split and the device launches of one outer iteration."""
    from repro_torch.apps.cfd import CFDConfig, SolverOptions, driver, solve_steady
    from repro_torch.core import precision
    from repro_torch.launch.mesh import make_mesh_for_devices

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = CFDConfig(n=n, outer_iters=CFD_FULL_OUTERS, tol=0.0,
                    policy=precision.get_policy(policy))
    opts, mesh = SolverOptions(backend="spmd"), make_mesh_for_devices()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, v, p, hist = solve_steady(cfg, opts, mesh, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(n=n, cells=n * n, policy=policy, outers=len(hist),
               ms_per_outer=wall / len(hist) * 1e3, continuity=hist,
               finite=all(math.isfinite(h) for h in hist)
               and bool(torch.isfinite(torch.stack([u.sum(), v.sum(), p.sum()])).all()),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if share:
        check(out["finite"] and len(hist) == CFD_FULL_OUTERS,
              f"10d: n={n} {policy} ran {len(hist)} outer iterations, continuity {hist}")
        out["split"] = driver.measure_solve_share(cfg, opts, mesh, (u, v, p),
                                                  reps=CFD_SHARE_REPS)
        step = driver.make_step_fn(cfg, opts, mesh)
        prof = profile_window(torch, lambda: step(u, v, p, u, v))
        out["launches_per_outer"] = prof.pop("launches")
        out["profile"] = prof
    emit(dict(phase="cfd_full", card=smi, **out))
    return out


def phase10(torch, smi: str) -> dict:
    """10a the Ghia cell on the card and the CPU, 10b the other steady
    cells, 10c the transient fault replay, 10d full size (module
    docstring); none of it may launch a kernel."""
    from repro_torch.kernels import launch_counts

    before = launch_counts()
    t0 = time.perf_counter()
    out: dict = {}

    # -- 10a: Ghia validation, the card against the port's CPU run -------------
    ghia = cell_flags("cavity_ghia") + CFD_STEADY
    card, cpu = run_cfd_quiet(ghia), run_cfd_quiet(ghia, device="cpu")
    if card and cpu:
        fields = cavity_fields(torch, card)
        gap = max(abs(a - b) for a, b in zip(card["centerline"], cpu["centerline"]))
        check(card["converged"] and card["ghia_ok"], f"10a: {steady_summary(card)}")
        check(fields["max_div"] < 1e-4, f"10a: divergence {fields['max_div']!r}")
        check(fields["max_wall"] == 0.0, f"10a: wall faces {fields['max_wall']!r}")
        check(gap <= 1e-3, f"10a: centerline {gap!r} from the CPU run's")
        out["ghia"] = dict(on_card=steady_summary(card), on_cpu=steady_summary(cpu),
                           centerline_gap=gap, centerline_min=min(card["centerline"]),
                           **fields)
        emit(dict(phase="cfd_ghia", card=smi, **out["ghia"]))
        out["ghia"]["centerline"] = card["centerline"]      # phase 12e's yardstick

    # -- 10b: the other steady cells, and the cavity at bf16_mixed -------------
    out["cells"] = {}
    for name in ("cavity_raw_jacobi", "cavity_pipelined"):
        res = run_cfd_quiet(cell_flags(name) + CFD_STEADY)
        if res:
            check(res["converged"], f"10b: {name} did not converge: {steady_summary(res)}")
            out["cells"][name] = steady_summary(res)
    res = run_cfd_quiet(cell_flags("cavity_ghia") + ["--policy", "bf16_mixed", "--outer",
                                                     str(CFD_BF16_OUTERS), "--no-check"])
    if res:
        finite = all(bool(torch.isfinite(f).all()) for f in res["state"])
        diags = bf16_diagonals(torch, res["state"])
        check(finite, f"10b: the bf16_mixed cavity is not finite after {CFD_BF16_OUTERS} "
                      f"outer iterations (continuity {res['history'][-5:]})")
        check(all(d > 0 for d in diags.values()), f"10b: a zero bf16 diagonal: {diags}")
        out["cells"]["cavity_bf16_mixed"] = dict(steady_summary(res), finite=finite,
                                                 continuity=res["history"][-1],
                                                 min_bf16_diagonal=diags)
    emit(dict(phase="cfd_cells", card=smi, **out["cells"]))

    # -- 10c: transient fault replay, checkpoints across devices ----------------
    out["transient"] = cfd_transient(torch, smi)

    # -- 10d: full size -----------------------------------------------------------
    out["full"] = cfd_full(torch, smi, CFD_FULL_N, "f32", share=True)
    out["full_bf16"] = cfd_full(torch, smi, CFD_BF16_N, "bf16_mixed", share=False)

    after = launch_counts()
    check(after == before, f"10: the CFD runs launched kernels: {before} -> {after}")
    out["kernel_launches"] = {k: after[k] - before[k] for k in after}
    out["seconds"] = time.perf_counter() - t0
    emit(dict(phase="cfd_clock", card=smi, seconds=out["seconds"],
              kernel_launches=out["kernel_launches"]))
    return out


def profile_window(torch, run) -> dict:
    """Device time by kernel over ``run()`` (torch.profiler, CUDA activity)
    and the card's idle share of the window; ``run`` once first, outside
    the window, so the window holds only the steady loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            kernels[e.key[:120]] = dict(count=e.count, ms=e.self_device_time_total / 1e3)
    busy = sum(k["ms"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:16])
    return dict(window_ms=window_ms, busy_ms=busy, idle_share=1 - busy / window_ms,
                launches=sum(k["count"] for k in kernels.values()), kernels_by_device_ms=top)


def profile_paths(torch, iters: int = PROFILE_ITERS) -> list[dict]:
    """A few ``bf16_mixed`` iterations of each measured path under the
    profiler: phase 4's solve at the paper mesh, phase 5's batched solve at
    608^3 x 4, phase 7's ``solve_ref_fused`` at the paper mesh, and phase
    8b's five paths at the paper mesh (the heterogeneous operator drawn on
    the card here: the profile times the work, not a seed's system)."""
    from repro_torch.core import bicgstab, precision, stencil
    from repro_torch.core.precond import PrecondConfig
    from repro_torch.launch.mesh import make_mesh_for_devices

    dev = torch.device("cuda")
    mesh = make_mesh_for_devices()
    paths = [("paper_mesh", PAPER_MESH, 1, "bicgstab", "convdiff", "none"),
             ("batched", JOULE_MESH, MAIN_NRHS, "bicgstab", "convdiff", "none"),
             ("ref_fused", PAPER_MESH, 1, None, "convdiff", "none")]
    for label, p in SLICE_PATHS.items():
        paths.append((label, PAPER_MESH, 1, p.solver, p.problem, p.precond))
    out = []
    for path, shape, nrhs, solver, problem, precond in paths:
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(1)
        if problem == "convdiff":
            cf = stencil.convection_diffusion(shape, device=dev)
        elif problem == "poisson":
            cf = stencil.poisson(shape, device=dev)
        else:
            cf = stencil.heterogeneous_poisson(gen, shape)
        xshape = (nrhs,) + shape if nrhs > 1 else shape
        x = torch.randn(xshape, generator=gen, device=dev)
        b = stencil.rhs_for_solution(cf, x).to(torch.bfloat16)
        cf = cf.astype(torch.bfloat16)
        del x
        if solver is None:
            run = lambda: bicgstab.solve_ref_fused(cf, b, tol=0.0, maxiter=iters)
        else:
            pc = PrecondConfig(name=precond, degree=CHEB_DEGREE)
            run = lambda: bicgstab.solve_distributed(mesh, cf, b, tol=0.0, maxiter=iters,
                                                     policy=precision.MIXED, backend="fused",
                                                     solver=solver, precond=pc)
        out.append(dict(phase="profile", path=path, shape=list(shape), nrhs=nrhs,
                        iterations=iters, **profile_window(torch, run)))
        del cf, b, run
    return out


# ---------------------------------------------------------------------------
# Phase 11: the LM serving path (dense decoder family; no kernel on its path)
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores, NVIDIA data sheet
LM_ARCHS = ("qwen2_1_5b", "deepseek_7b", "stablelm_12b", "gemma3_12b")
#: (batch, prompt tokens, decode steps) of each run
LM_SMOKE = (2, 32, 8)        # 11a: the tests' smoke shapes
LM_WIDE_CHECK = (1, 64, 4)   # 11b: qwen2_1_5b at full width, card against CPU
LM_SERVE = (8, 2048, 128)    # 11c: requests, prompt, new tokens each (prefill + 127 decodes)
LM_LONG = (1, 32768, 32)     # 11d: prefill_32k / decode_32k, batch cut from 32 / 128 to 1
LM_WINDOW = (1, 4096, 16)    # 11e: gemma3_12b at full width, depth cut 48 -> 6 (one period)
#: f32 logits, card against CPU, as a share of the CPU's largest |logit|:
#: at smoke width the f32 tolerance of tests/test_torch_lm_serve.py (16 ulps);
#: at full width 2^-10, for 28 layers of sums over 1,536-8,960 terms in
#: other orders (each layer's relative error about sqrt(n) eps ~ 100 eps,
#: summed over 28 layers ~ 2^-11.5, with 3x room)
LM_F32_TOL = {"smoke": 16 * EPS_F32, "wide": 2.0 ** -10}
#: bf16 logits: the card's bf16 run may be at most this many times further
#: from the CPU's f32 run than the CPU's own bf16 run is
LM_BF16_FACTOR = 2.0


def lm_models(torch, cfg, tree, device, dtype):
    """The model of ``tree`` (a stacked parameter tree) on ``device`` in
    ``dtype`` (bfloat16: the tree as it is, norms in f32; float32: every
    leaf widened exactly)."""
    from repro_torch.models.param import map_tree
    from repro_torch.models.transformer import DecoderLM

    c = dataclasses.replace(cfg, dtype=dtype)
    return c, DecoderLM.from_tree(c, map_tree(
        lambda t: t.to(device=device, dtype=torch.float32 if dtype == torch.float32
                       else t.dtype), tree))


def lm_run(torch, cfg, model, tokens, steps: int, forced=None):
    """Prefill + ``steps`` decodes; returns every step's last-position logits
    as one f32 CPU tensor (steps + 1, B, V) and the tokens fed to the
    decodes (the greedy ones unless ``forced``)."""
    from repro_torch.models import model as M

    dev = model.embed.device
    B, T = tokens.shape
    caches = M.init_caches(cfg, B, T + steps, dev)
    logits, caches = M.make_prefill_step(cfg, M.SHAPES["prefill_32k"])(
        model, {"tokens": tokens.to(dev)}, caches)
    serve = M.make_serve_step(cfg)
    out, fed = [logits[:, -1].float().cpu()], []
    for s in range(steps):
        tok = forced[s] if forced is not None else out[-1].argmax(-1)
        fed.append(tok)
        logits, caches = serve(model, {"token": tok[:, None].to(dev)}, caches)
        out.append(logits[:, -1].float().cpu())
    return torch.stack(out), torch.stack(fed)


def lm_card_vs_cpu(torch, cfg, tree, shape, f32_tol: float) -> dict:
    """One model's weights served on the card and on the CPU, each in f32
    and bf16, every decode fed the CPU f32 run's greedy tokens.  f32: the
    card within ``f32_tol`` of the CPU's largest |logit|; bf16: the card no
    more than ``LM_BF16_FACTOR`` times as far from the CPU's f32 logits as
    the CPU's bf16 logits are.  Greedy tokens agree wherever the CPU's top-2
    gap exceeds the tolerance."""
    B, T, steps = shape
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=torch.Generator().manual_seed(11))
    runs = {}
    for side, dev in (("cpu", "cpu"), ("card", "cuda")):
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            c, model = lm_models(torch, cfg, tree, dev, dt)
            forced = runs["cpu_f32"][1] if runs else None
            runs[f"{side}_{name}"] = lm_run(torch, c, model, tokens, steps, forced)
            del model
            torch.cuda.empty_cache()
    cpu32, cpu16 = runs["cpu_f32"][0], runs["cpu_bf16"][0]
    card32, card16 = runs["card_f32"][0], runs["card_bf16"][0]

    def gap(a, b):
        return float((a - b).abs().max())

    tol32 = f32_tol * float(cpu32.abs().max())
    ref16 = gap(cpu16, cpu32)
    out = dict(f32_err=gap(card32, cpu32), f32_tol=tol32, f32_err_rel=gap(card32, cpu32)
               / float(cpu32.abs().max()), bf16_card_vs_cpu_f32=gap(card16, cpu32),
               bf16_cpu_vs_cpu_f32=ref16, bf16_card_vs_cpu_bf16=gap(card16, cpu16),
               finite=all(bool(torch.isfinite(r[0]).all()) for r in runs.values()))
    check(out["finite"], f"11 {cfg.name}: non-finite logits")
    check(out["f32_err"] <= tol32, f"11 {cfg.name}: f32 card vs CPU {out['f32_err']!r} > {tol32!r}")
    check(out["bf16_card_vs_cpu_f32"] <= LM_BF16_FACTOR * ref16,
          f"11 {cfg.name}: bf16 card {out['bf16_card_vs_cpu_f32']!r} from the CPU's f32 logits, "
          f"more than {LM_BF16_FACTOR} x the CPU bf16 run's {ref16!r}")
    # the card and the CPU run in one dtype differ by at most tol32 (f32) or
    # (1 + LM_BF16_FACTOR) x ref16 (bf16), so a gap above that decides the token
    for name, card, cpu, tol in (("f32", card32, cpu32, tol32),
                                 ("bf16", card16, cpu16, (1 + LM_BF16_FACTOR) * ref16)):
        top2 = cpu.topk(2, dim=-1).values
        decisive = (top2[..., 0] - top2[..., 1]) > tol
        agree = card.argmax(-1) == cpu.argmax(-1)
        out[f"{name}_tokens_decisive"] = int(decisive.sum())
        out[f"{name}_tokens_agree"] = int((agree & decisive).sum())
        check(bool((agree | ~decisive).all()),
              f"11 {cfg.name}: {name} greedy tokens differ where the CPU's top-2 gap > {tol!r}")
    return out


def lm_param_bytes(cfg) -> int:
    from repro_torch.models.param import tree_leaves
    from repro_torch.models.transformer import build_model_defs

    return sum(math.prod(d.shape) * d.dtype.itemsize
               for _, d in tree_leaves(build_model_defs(cfg)))


def lm_keys_per_layer(cfg, T: int) -> list[int]:
    """Keys each layer's causal attention must read over a prompt of T
    (sum over queries of the keys in reach: all before it, or the window)."""
    out = []
    for spec in cfg.layer_specs():
        w = spec.window or T
        out.append(sum(min(q + 1, w) for q in range(T)) if w < T else T * (T + 1) // 2)
    return out


def lm_bounds(cfg, B: int, T: int, steps: int) -> dict:
    """The least time the card could take (ms): the prefill's operations at
    989 TFLOP/s or its bytes (weights read once, the cache written once) at
    3.35 TB/s, whichever is larger; one decode step's bytes (every weight
    read once, the tied or untied head included, and each layer's cache up
    to its length or window, at the steps' mean length) or operations."""
    d, H, K, Dh, F, V = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab
    mlp = (3 if cfg.act in ("swiglu", "geglu") else 2) * d * F
    per_layer = 2 * d * H * Dh + 2 * d * K * Dh + mlp
    w_bytes = lm_param_bytes(cfg)
    item = 2
    kv_tok = cfg.n_layers * 2 * K * Dh * item
    attn = sum(4 * B * H * Dh * k for k in lm_keys_per_layer(cfg, T))
    pre_ops = 2 * B * T * cfg.n_layers * per_layer + attn + 2 * B * d * V
    pre_bytes = w_bytes + B * T * kv_tok
    lens = [T + s + 1 for s in range(steps)]
    kv_read = sum(sum(B * min(L, spec.window or L) * 2 * K * Dh * item
                      for spec in cfg.layer_specs()) for L in lens) / len(lens)
    dec_ops = 2 * B * (cfg.n_layers * per_layer + d * V) + sum(
        sum(4 * B * H * Dh * min(L, spec.window or L) for spec in cfg.layer_specs())
        for L in lens) / len(lens)
    pre = max(pre_ops / PEAK_BF16_FLOPS, pre_bytes / PEAK_BYTES_PER_S) * 1e3
    dec = max(dec_ops / PEAK_BF16_FLOPS, (w_bytes + kv_read) / PEAK_BYTES_PER_S) * 1e3
    return dict(weight_bytes=w_bytes, prefill_flops=pre_ops, prefill_bound_ms=pre,
                prefill_bound_by="operations" if pre_ops / PEAK_BF16_FLOPS
                > pre_bytes / PEAK_BYTES_PER_S else "bytes",
                decode_bytes=w_bytes + kv_read, decode_flops=dec_ops, decode_bound_ms=dec,
                decode_bound_by="bytes" if (w_bytes + kv_read) / PEAK_BYTES_PER_S
                > dec_ops / PEAK_BF16_FLOPS else "operations")


def lm_serve(torch, smi: str, cfg, shape, label: str, cut: str | None = None, reps: int = 1,
             profile: bool = False) -> dict:
    """Serve ``shape`` = (B, T, new tokens) on the card, bf16, random weights
    from a seed: a batched prefill, then new - 1 greedy decode steps (the
    prefill gives the first token).  Host clock around each phase, ending
    in a synchronise; ``reps`` times on the same weights, the first rep also
    reading peak memory.  Every logit must be finite."""
    from repro_torch.models import model as M

    B, T, new = shape
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    prefill, serve = M.make_prefill_step(cfg, M.SHAPES["prefill_32k"]), M.make_serve_step(cfg)
    runs = []
    for rep in range(reps):
        caches = M.init_caches(cfg, B, T + new, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": tokens}, caches)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1)[:, None]
        t0 = time.perf_counter()
        for _ in range(new - 1):
            logits, caches = serve(params, {"token": tok}, caches)
            finite &= torch.isfinite(logits).all()
            tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        runs.append(dict(prefill_ms=t_pre * 1e3, prefill_tokens_per_s=B * T / t_pre,
                         decode_ms_per_step=t_dec * 1e3 / (new - 1),
                         decode_tokens_per_s=B * (new - 1) / t_dec,
                         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                         finite=bool(finite), cache_length=caches[0]["attn"].length))
        check(runs[-1]["finite"], f"11 {label}: non-finite logits (rep {rep})")
        check(runs[-1]["cache_length"] == T + new - 1, f"11 {label}: cache length "
              f"{runs[-1]['cache_length']} != {T + new - 1}")
    out = dict(phase="lm_serve", cell=label, card=smi, arch=cfg.name, n_layers=cfg.n_layers,
               batch=B, prompt=T, new_tokens=new, decode_steps=new - 1, dtype="bfloat16", cut=cut,
               kv_cache_gb=B * (T + new) * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.d_head * 2 / 1e9,
               runs=runs, **lm_bounds(cfg, B, T, new - 1))
    if profile:
        # 5 decode steps from the prompt's cache (rewound: positions T.. again)
        from repro_torch.models.attention import AttnCache

        rewound = [{"attn": AttnCache(c["attn"].k, c["attn"].v, T)} for c in caches]

        def steps():
            cs, t = rewound, tok
            for _ in range(PROFILE_ITERS):
                lg, cs = serve(params, {"token": t}, cs)
                t = lg[:, -1].argmax(-1)[:, None]

        out["profile"] = dict(decode_steps=PROFILE_ITERS, **profile_window(torch, steps))
    del params, caches, logits
    torch.cuda.empty_cache()
    emit(out)
    return out


def phase11(torch, smi: str, profile: bool = False) -> dict:
    """11a-11e (module docstring): the dense LM serving path on the card,
    held to the port's CPU run, then served at full width; none of it may
    launch a kernel."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import launch_counts
    from repro_torch.models.param import init_tree
    from repro_torch.models.transformer import build_model_defs

    before = launch_counts()
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    out: dict = {}

    # -- 11a: the four smoke configs, card against CPU ---------------------------
    out["smoke"] = {}
    for arch in LM_ARCHS:
        cfg = get_smoke(arch)
        tree = init_tree(build_model_defs(cfg), torch.Generator(dev).manual_seed(0), dev)
        out["smoke"][arch] = lm_card_vs_cpu(torch, cfg, tree, LM_SMOKE, LM_F32_TOL["smoke"])
        del tree
    emit(dict(phase="lm_smoke_card_vs_cpu", card=smi, batch=LM_SMOKE[0], prompt=LM_SMOKE[1],
              decode_steps=LM_SMOKE[2], **out["smoke"]))

    # -- 11b: qwen2_1_5b at full width, card against CPU -------------------------
    cfg = get_config("qwen2_1_5b")
    tree = init_tree(build_model_defs(cfg), torch.Generator(dev).manual_seed(0), dev)
    out["wide"] = lm_card_vs_cpu(torch, cfg, tree, LM_WIDE_CHECK, LM_F32_TOL["wide"])
    del tree
    torch.cuda.empty_cache()
    emit(dict(phase="lm_full_width_card_vs_cpu", card=smi, arch=cfg.name, n_layers=cfg.n_layers,
              batch=LM_WIDE_CHECK[0], prompt=LM_WIDE_CHECK[1], decode_steps=LM_WIDE_CHECK[2],
              **out["wide"]))

    # -- 11c-11e: serving at full width ------------------------------------------
    out["serve"] = lm_serve(torch, smi, cfg, LM_SERVE, "serve_8x2048", reps=2, profile=profile)
    out["long"] = lm_serve(torch, smi, cfg, LM_LONG, "prefill_decode_32k_batch1",
                           cut="batch 32 (prefill_32k) and 128 (decode_32k) -> 1")
    gemma = get_config("gemma3_12b")
    gemma = dataclasses.replace(gemma, n_layers=len(gemma.period))
    out["window"] = lm_serve(torch, smi, gemma, LM_WINDOW, "gemma3_one_period_4096",
                             cut="depth 48 -> 6 (one period: 5 windowed layers, 1 global)")

    after = launch_counts()
    check(after == before, f"11: the LM runs launched kernels: {before} -> {after}")
    out["kernel_launches"] = {k: after[k] - before[k] for k in after}
    out["matmul_flags"] = dict(
        allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        allow_bf16_reduced_precision_reduction=(
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction))
    out["seconds"] = time.perf_counter() - t0
    emit(dict(phase="lm_clock", card=smi, seconds=out["seconds"],
              kernel_launches=out["kernel_launches"], matmul_flags=out["matmul_flags"]))
    return out


# ---------------------------------------------------------------------------
# Phase 12: the multi-rank solve, four gloo ranks sharing the one card
# ---------------------------------------------------------------------------

P12_WORLD = 4
#: 12a: global_apply cases: (shape, spec); each in f32 and bf16, B = 0 and 3
P12_APPLY = [(DEFAULT_MESH, "star7"), (PAPER_MESH, "star7"), (FAMILY_MESH, "box27"),
             (FAMILY_MESH, "star25")]
P12_BATCHES = (0, 3)
#: the ranks' own time limit (a torchrun launch), and the world-of-1 run's
P12_TIMEOUT, P12D_TIMEOUT = 480, 240
#: the hash multipliers of :func:`hashed_field`, one per axis (batch first)
_HASH = (73856093, 19349663, 83492791, 2654435761)


def hashed_field(torch, shape, region, salt: int, dtype, device, scale: float):
    """A field of global ``shape`` on the block ``region`` (one slice per
    axis): values ``scale * (h % 65536 / 65536 - 1/2)`` from an integer hash
    of the global index, so a rank makes its block and rank 0 the whole
    array with the same bits, and no array crosses between them."""
    idx = [torch.arange(s.start, s.stop, device=device, dtype=torch.int64)
           for s in region]
    out = torch.empty([len(i) for i in idx], dtype=dtype, device=device)
    mults = _HASH[-len(shape):]
    first = len(shape) - 3                      # chunks along the first mesh axis
    for lo in range(0, len(idx[first]), 32):
        h = torch.full((1,) * len(shape), salt * 40503, dtype=torch.int64, device=device)
        for d, (i, m) in enumerate(zip(idx, mults)):
            i = i[lo:lo + 32] if d == first else i
            h = h ^ (i * m).reshape([-1 if e == d else 1 for e in range(len(shape))])
        sl = (slice(None),) * first + (slice(lo, lo + 32),)
        out[sl] = (((h % 65536).to(torch.float32) / 65536.0 - 0.5) * scale).to(dtype)
    return out


def p12_system(torch, shape, spec, dtype, nb: int, region, device):
    """Coefficients (unit diagonal, each in +-1/n_offsets) and an iterate
    of ``nb`` RHS (0: unbatched) on ``region`` of the global arrays."""
    from repro_torch.core.stencil import StencilCoeffs

    cf = StencilCoeffs({n: hashed_field(torch, shape, region, k + 1, dtype, device,
                                        2.0 / spec.n_offsets)
                        for k, n in enumerate(spec.names)})
    vshape = ((nb,) if nb else ()) + tuple(shape)
    vreg = ((slice(0, nb),) if nb else ()) + tuple(region)
    return cf, hashed_field(torch, vshape, vreg, 99, dtype, device, 2.0)


def p12_apply(torch, device) -> list[dict]:
    """12a on every rank: the four-rank K1/K1b SpMV of each case in the
    blocking, overlap-split and overlap-fused forms, their bits against
    each other, and (on rank 0) the gathered output against the one-rank
    K1 of the whole array."""
    from repro_torch.core import dist, precision, stencil, tuning
    from repro_torch.core.comm import BLOCKING, OVERLAP
    from repro_torch.core.halo import FabricAxes, block_slices
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.stencil_nd.ops import fused_local_apply
    from repro_torch.launch.mesh import make_mesh_for_devices

    td = dist._td()
    fabric = FabricAxes.from_mesh(make_mesh_for_devices(P12_WORLD))
    rank = dist.rank()
    recs = []
    for shape, sname in P12_APPLY:
        spec = stencil.get_spec(sname)
        for pol in (precision.F32, precision.MIXED):
            for nb in P12_BATCHES:
                whole = tuple(slice(0, s) for s in shape)
                want = None
                if rank == 0:     # the one-rank K1 of the whole array: one launch
                    cf, v = p12_system(torch, shape, spec, pol.storage, nb, whole, device)
                    want = fused_local_apply(cf, v, FabricAxes(), policy=pol,
                                             schedule=BLOCKING).cpu()
                    del cf, v
                    torch.cuda.empty_cache()
                td.barrier()
                mine = block_slices(fabric, shape)
                cf, v = p12_system(torch, shape, spec, pol.storage, nb, mine, device)
                ring = dataclasses.replace(tuning.default_config(
                    spec, pol.storage, cf.shape, max(nb, 1)), fuse_ring=True)
                forms, counts = {}, {}
                for form, kw in (("blocking", dict(schedule=BLOCKING)),
                                 ("overlap_split", dict(schedule=OVERLAP)),
                                 ("overlap_fused", dict(schedule=OVERLAP, config=ring))):
                    reset_launch_counts()
                    forms[form] = fused_local_apply(cf, v, fabric, policy=pol, **kw)
                    torch.cuda.synchronize()
                    counts[form] = {k: n for k, n in launch_counts().items() if n}
                same = all(torch.equal(forms[f], forms["blocking"]) for f in forms)
                block = forms["blocking"].cpu()
                del cf, v, forms
                torch.cuda.empty_cache()
                equal_whole = None
                if rank == 0:
                    pre = (slice(None),) * (1 if nb else 0)
                    equal_whole = torch.equal(want[pre + mine], block)
                    for r in range(1, P12_WORLD):
                        buf = torch.empty_like(block)
                        td.recv(buf.reshape(-1).view(torch.uint8), r)
                        sl = block_slices(fabric.at_rank(r), shape)
                        equal_whole = equal_whole and torch.equal(want[pre + sl], buf)
                        del buf
                else:
                    td.send(block.reshape(-1).view(torch.uint8), 0)
                del want, block
                recs.append(dict(shape=list(shape), spec=sname, policy=pol.name, nrhs=nb,
                                 forms_equal=same, equal_one_rank=equal_whole,
                                 launches=counts))
    return recs


def p12_dot_order(torch, device, seed: int) -> bool:
    """12b: the default cell's f32 solve across the ranks through spmd and
    through the kernels with spmd-order dots: the same bits on every rank."""
    from repro_torch.core import bicgstab, dist, precision, stencil
    from repro_torch.core.halo import FabricAxes, local_apply
    from repro_torch.core.operator import make_operator
    from repro_torch.core.solvers import get_solver
    from repro_torch.launch import solve
    from repro_torch.launch.mesh import make_mesh_for_devices

    mesh = make_mesh_for_devices(P12_WORLD)
    fabric = FabricAxes.from_mesh(mesh)
    f32 = precision.F32
    _, cf, xt = solve.rank_system(None, stencil.STAR7, DEFAULT_MESH, fabric, seed=seed,
                                  device=device)
    b = local_apply(cf, xt, fabric, policy=f32)
    spmd = bicgstab.solve_block(mesh, cf, b, tol=1e-6, maxiter=200, policy=f32,
                                backend="spmd")
    op = with_spmd_dots(make_operator("fused", cf, fabric, policy=f32))
    fused = get_solver("bicgstab")(op, b, None, tol=1e-6, maxiter=200, policy=f32)
    same = (torch.equal(spmd.x, fused.x) and int(spmd.iterations) == int(fused.iterations))
    return all(dist.all_gather_object(bool(same)))


def p12_cli(argv) -> tuple[dict, dict]:
    """The solve CLI in this rank, its lines kept off the output."""
    res, counts = run_cli_quiet(argv + ["--dist-backend", "gloo"])
    return res, {k: n for k, n in counts.items() if n}


def p12_rank_part(torch, device, out_dir: Path) -> dict:
    """Everything phase 12 runs on each of four gloo ranks (12a, b, c, e, f)."""
    import os

    from repro_torch.kernels import launch_counts

    out: dict = {}
    t0 = time.perf_counter()
    out["apply"] = p12_apply(torch, device)
    out["apply_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    runs = []
    for seed in range(PHASE3_SEEDS):
        fused, fc = p12_cli(["--backend", "fused", "--policy", "f32", "--seed", str(seed)])
        spmd, _ = p12_cli(["--backend", "spmd", "--policy", "f32", "--seed", str(seed)])
        runs.append(dict(seed=seed, fused=fused, spmd=spmd, launches=fc,
                         spmd_order_dots_equal=p12_dot_order(torch, device, seed)))
    out["cli"] = runs
    out["cli_s"] = time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = [str(s) for s in PAPER_MESH]
    res, counts = p12_cli(["--mesh", *mesh, "--backend", "fused", "--policy", "bf16_mixed",
                           "--tol", "0", "--maxiter", str(MAIN_ITERS)])
    res.update(launches=counts, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    out["paper_mesh"] = res
    torch.cuda.empty_cache()

    # 12f: --autotune across the ranks (rank 0 sweeps and writes, the others
    # look its entry up), then a run that every rank finds in the cache, with
    # --obs (rank 0 writes the bundle); its launches are the solve's alone
    os.environ["REPRO_TORCH_TUNING_CACHE"] = str(out_dir / "tuning_cache.json")
    flags = ["--mesh", *mesh, "--backend", "fused", "--policy", "bf16_mixed", "--tol", "0",
             "--maxiter", str(MAIN_ITERS), "--autotune"]
    sweep, _ = p12_cli(flags)
    res, counts = p12_cli(flags + ["--obs", "--run-dir", str(out_dir / "bundle")])
    keep = ("iterations", "rel_residual", "true_rel_residual", "ms_per_iter")
    out["autotune"] = dict(launches=counts, cache_hit=res["autotune"]["cache_hit"],
                           sweep_cache_hit=sweep["autotune"]["cache_hit"],
                           config=sweep["autotune"]["config"],
                           speedup_vs_default=sweep["autotune"].get("speedup_vs_default"),
                           n_candidates=sweep["autotune"].get("n_candidates"),
                           sweep_run={k: sweep[k] for k in keep},
                           collectives=res["collectives"], **{k: res[k] for k in keep})
    del os.environ["REPRO_TORCH_TUNING_CACHE"]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    before = launch_counts()
    ghia = run_cfd_quiet(cell_flags("cavity_ghia") + CFD_STEADY + ["--dist-backend", "gloo"])
    after = launch_counts()
    out["ghia"] = dict(steady_summary(ghia), centerline=ghia.get("centerline"),
                       kernel_launches={k: after[k] - before[k] for k in after if
                                        after[k] != before[k]},
                       seconds=time.perf_counter() - t0)
    return out


def p12_world_of_one(torch, device) -> dict:
    """12d: phase 4's run under torchrun with one nccl rank."""
    res, counts = run_cli_quiet(["--mesh", *(str(s) for s in PAPER_MESH), "--backend",
                                 "fused", "--policy", "bf16_mixed", "--tol", "0",
                                 "--maxiter", str(MAIN_ITERS), "--dist-backend", "nccl"])
    return dict(res, launches=counts)


def rank_main(part: str, out_dir: Path) -> int:
    """One rank of a phase-12 launch (``torchrun ... chip_smoke.py --rank-part
    PART --rank-out DIR``): joins the group, runs its part, writes
    ``DIR/rank<r>.json``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dist

    device = dist.init("nccl" if part == "world_of_one" else "gloo", device_type="cuda")
    rank = dist.rank()
    rec = (p12_world_of_one(torch, device) if part == "world_of_one"
           else p12_rank_part(torch, device, out_dir))
    rec.update(rank=rank, device=str(device), failures=failures)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(rec, default=str))
    dist.shutdown()
    return 1 if failures else 0


def launch_ranks(part: str, nproc: int, timeout: int) -> tuple[list[dict], Path]:
    """``torchrun --standalone --nproc-per-node nproc chip_smoke.py`` for one
    part, in its own process group (killed whole at the time limit); every
    rank's record (or a failure), and the directory the ranks wrote to."""
    import os
    import signal
    import tempfile

    out_dir = Path(tempfile.mkdtemp(prefix=f"phase12_{part}_"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", str(ROOT / "chip_smoke.py"), "--rank-part", part,
           "--rank-out", str(out_dir)]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        check(False, f"12 {part}: the ranks passed the {timeout} s limit: {log[-1500:]}")
        return [], out_dir
    recs = [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(nproc) if (out_dir / f"rank{r}.json").exists()]
    check(proc.returncode == 0 and len(recs) == nproc,
          f"12 {part}: torchrun exited {proc.returncode} with {len(recs)} of {nproc} "
          f"records: {log[-3000:]}")
    for rec in recs:
        for f in rec.get("failures", []):
            check(False, f"12 {part} rank {rec['rank']}: {f}")
    return recs, out_dir


def p12_expected(iters: int, ring_patches: int) -> dict:
    """A rank's launches over ``iters`` fused iterations with a split ring of
    ``ring_patches`` slabs per SpMV."""
    counts = {k: n for k, n in expected_counts(iters).items() if n}
    counts["stencil_nd"] = 2 * iters * (1 + ring_patches)
    return counts


def phase12(torch, smi: str, phase4: dict, ghia_centerline) -> dict:
    """12a-e (module docstring): four gloo ranks sharing this card, then
    one nccl rank."""
    t0 = time.perf_counter()
    label = "4 gloo ranks sharing one card"
    out: dict = dict(label=label, card=smi)
    torch.cuda.empty_cache()
    recs, out_dir = launch_ranks("ranks", P12_WORLD, P12_TIMEOUT)
    if len(recs) == P12_WORLD:
        r0 = recs[0]
        # 12a: bits and per-rank launches of every form
        for i, case in enumerate(r0["apply"]):
            what = f"12a {case['spec']} {case['shape']} {case['policy']} B={case['nrhs']}"
            check(case["equal_one_rank"], f"{what}: the gathered SpMV differs from the "
                                          f"one-rank K1's bits")
            kern = "stencil_nd_batched" if case["nrhs"] else "stencil_nd"
            want = {"blocking": {kern: 1}, "overlap_split": {kern: 5},
                    "overlap_fused": {kern: 1}}
            for rec in recs:
                c = rec["apply"][i]
                check(c["forms_equal"], f"{what} rank {rec['rank']}: the schedules and ring "
                                        f"forms differ")
                check(c["launches"] == want, f"{what} rank {rec['rank']}: launches "
                                             f"{c['launches']} != {want}")
        out["apply"] = [dict(c, launches_per_rank=[rec["apply"][i]["launches"] for rec in recs])
                        for i, c in enumerate(r0["apply"])]
        emit(dict(phase="ranks_apply", label=label, card=smi, seconds=r0["apply_s"],
                  cases=[{k: c[k] for k in ("shape", "spec", "policy", "nrhs",
                                            "equal_one_rank", "forms_equal")}
                         for c in out["apply"]]))

        # 12b: the CLI at the default cell, seeds 0-4
        runs = []
        for s, run in enumerate(r0["cli"]):
            fused, spmd = run["fused"], run["spmd"]
            n = fused["iterations"]
            check(fused["converged"] and fused["true_rel_residual"] < 1e-5,
                  f"12b seed {s}: fused {fused['converged']}, true rel-residual "
                  f"{fused['true_rel_residual']!r}")
            check(run["spmd_order_dots_equal"], f"12b seed {s}: spmd-order dots differ from "
                                                f"the spmd solve")
            for rec in recs:
                c = rec["cli"][s]["fused"]["collectives"]
                check(c == {"allreduce_total": 1 + 3 * n, "ppermute_total": 8 * n},
                      f"12b seed {s} rank {rec['rank']}: collectives {c}, n={n}")
                check(rec["cli"][s]["launches"] == p12_expected(n, 4),
                      f"12b seed {s} rank {rec['rank']}: launches {rec['cli'][s]['launches']}")
            runs.append(dict(seed=s, fused_iterations=n, spmd_iterations=spmd["iterations"],
                             fused_true_rel_residual=fused["true_rel_residual"],
                             spmd_true_rel_residual=spmd["true_rel_residual"],
                             fused_ms_per_iter=fused["ms_per_iter"],
                             spmd_ms_per_iter=spmd["ms_per_iter"],
                             collectives=fused["collectives"],
                             spmd_order_dots_equal=run["spmd_order_dots_equal"]))
        gaps = gap_check("12b fused vs spmd on 4 ranks",
                         [r["fused_iterations"] - r["spmd_iterations"] for r in runs],
                         SEED_GAP, mean=MEAN_GAP)
        out["cli"] = dict(runs=runs, **gaps)
        emit(dict(phase="ranks_cli", label=label, card=smi, seconds=r0["cli_s"], **out["cli"]))

        # 12c: cs1_paper across the ranks
        pm = [rec["paper_mesh"] for rec in recs]
        res = pm[0]
        finite = all(math.isfinite(res[k]) for k in ("rel_residual", "true_rel_residual"))
        check(finite and res["rel_residual"] < 1 and res["true_rel_residual"] < 1,
              f"12c residuals {res['rel_residual']!r}, {res['true_rel_residual']!r}")
        want = p12_expected(MAIN_ITERS, 4)
        for rec, p in zip(recs, pm):
            check(p["launches"] == want, f"12c rank {rec['rank']}: launches {p['launches']} "
                                         f"!= {want}")
        out["paper_mesh"] = dict(
            iterations=res["iterations"], rel_residual=res["rel_residual"],
            true_rel_residual=res["true_rel_residual"],
            ms_per_iter=[p["ms_per_iter"] for p in pm],
            host_staged_bytes_per_iter=[p["host_staged_bytes"] / MAIN_ITERS for p in pm],
            peak_memory_gb=[p["peak_memory_gb"] for p in pm],
            launches_per_rank=[p["launches"] for p in pm],
            collectives=res["collectives"], setup_s=res["system_s"],
            phase4_ms_per_iter=phase4["ms_per_iter"])
        emit(dict(phase="ranks_paper_mesh", label=label, card=smi, **out["paper_mesh"]))

        # 12f: --autotune and --obs across the ranks
        tuned = [rec["autotune"] for rec in recs]
        t0f = tuned[0]
        check([t["sweep_cache_hit"] for t in tuned] == [False] + [True] * (P12_WORLD - 1),
              f"12f: rank 0 must sweep and the others hit its entry: "
              f"{[t['sweep_cache_hit'] for t in tuned]}")
        check(all(t["cache_hit"] for t in tuned), f"12f: the second run must hit the cache "
                                                  f"on every rank")
        check(all(t["config"] == t0f["config"] for t in tuned), f"12f: configs differ: "
                                                               f"{[t['config'] for t in tuned]}")
        for run in (t0f["sweep_run"], t0f):
            check(all(run[k] == res[k] for k in ("iterations", "rel_residual",
                                                 "true_rel_residual")),
                  f"12f: a tuned solve's residuals {run['rel_residual']!r}, "
                  f"{run['true_rel_residual']!r} differ from 12c's")
        fused_ring = bool(t0f["config"].get("fuse_ring"))
        want_f = p12_expected(MAIN_ITERS, 0 if fused_ring else 4)
        for rec, t in zip(recs, tuned):
            check(t["launches"] == want_f, f"12f rank {rec['rank']}: launches {t['launches']} "
                                           f"!= {want_f}")
        bundle = out_dir / "bundle"
        files = sorted(p.name for p in bundle.iterdir()) if bundle.is_dir() else []
        man = json.loads((bundle / "manifest.json").read_text()) if files else {}
        events = read_jsonl(bundle / "events.jsonl") if files else []
        coll = [e for e in events if e.get("event") == "collectives"]
        want_c = {"allreduce_total": 1 + 3 * MAIN_ITERS, "ppermute_total": 8 * MAIN_ITERS}
        check(files == ["events.jsonl", "manifest.json", "trace.json"], f"12f bundle: {files}")
        check(man.get("dist", {}).get("world_size") == P12_WORLD
              and man["dist"].get("backend") == "gloo"
              and man["dist"].get("rank_devices") == ["cuda:0"] * P12_WORLD,
              f"12f manifest dist: {man.get('dist')}")
        check(len(coll) == 1 and coll[0].get("per_rank") == [want_c] * P12_WORLD,
              f"12f collectives events: {coll}")
        out["autotune"] = dict(per_rank=tuned, fused_ring=fused_ring, bundle_files=files,
                               manifest_dist=man.get("dist"),
                               collectives=coll[0] if coll else None)
        emit(dict(phase="ranks_autotune_obs", label=label, card=smi, config=t0f["config"],
                  speedup_vs_default=t0f["speedup_vs_default"],
                  n_candidates=t0f["n_candidates"],
                  ms_per_iter=[t["ms_per_iter"] for t in tuned],
                  sweep_ms_per_iter=[t["sweep_run"]["ms_per_iter"] for t in tuned],
                  fused_ring=fused_ring,
                  manifest_dist=man.get("dist")))

        # 12e: the Ghia cavity on a 2x2 fabric
        g = r0["ghia"]
        gap = (max(abs(a - b) for a, b in zip(g["centerline"], ghia_centerline))
               if g.get("centerline") and ghia_centerline else float("inf"))
        check(bool(g.get("converged")) and bool(g.get("ghia_ok")), f"12e: {g}")
        check(gap <= 1e-3, f"12e: centerline {gap!r} from phase 10a's one-rank card run")
        check(not g["kernel_launches"], f"12e: the CFD ranks launched {g['kernel_launches']}")
        out["ghia"] = dict({k: v for k, v in g.items() if k != "centerline"},
                           centerline_gap=gap)
        emit(dict(phase="ranks_cfd_ghia", label=label, card=smi, **out["ghia"]))

    # 12d: a world of one under nccl is phase 4 bit for bit
    one, _ = launch_ranks("world_of_one", 1, P12D_TIMEOUT)
    if one:
        res = one[0]
        same = all(res[k] == phase4[k] for k in ("iterations", "rel_residual",
                                                 "true_rel_residual"))
        check(same, f"12d: a world of one under nccl gave {res['rel_residual']!r}, "
                    f"{res['true_rel_residual']!r}; phase 4 {phase4['rel_residual']!r}, "
                    f"{phase4['true_rel_residual']!r}")
        check(res["launches"] == phase4["launches"], f"12d: launches {res['launches']}")
        out["world_of_one"] = dict(same_as_phase4=same, ms_per_iter=res["ms_per_iter"],
                                   rel_residual=res["rel_residual"],
                                   true_rel_residual=res["true_rel_residual"])
        emit(dict(phase="world_of_one_nccl", card=smi, **out["world_of_one"]))
    out["seconds"] = time.perf_counter() - t0
    emit(dict(phase="ranks_clock", label=label, card=smi, seconds=out["seconds"]))
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few iterations of each measured path with "
                         "torch.profiler")
    ap.add_argument("--out", type=Path, default=Path("build/chip_smoke.json"),
                    help="where the full JSON record goes (relative to the checkout)")
    ap.add_argument("--rank-part", choices=["ranks", "world_of_one"],
                    help=argparse.SUPPRESS)      # phase 12's torchrun ranks
    ap.add_argument("--rank-out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU",
              file=sys.stderr)
        return 2
    if args.rank_part:
        return rank_main(args.rank_part, args.rank_out)
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
    ptxas = ptxas_summary(lib_path.with_suffix(".log").read_text())
    emit(dict(phase="ptxas", kernels=ptxas))
    grouped = {k: v for k, v in ptxas.items() if any(g in k for g in GROUP_KERNELS)}
    check(len(grouped) == 4 * len(GROUP_KERNELS) and all(
        v.get("spill_stores") == 0 and v.get("spill_loads") == 0 for v in grouped.values()),
          f"group kernels spill or are missing from the ptxas log: {grouped}")
    dots = {k: v for k, v in ptxas.items() if DOT_KERNEL in k}
    check(len(dots) == DOT_INSTANCES and all(
        v.get("spill_stores") == 0 and v.get("spill_loads") == 0 for v in dots.values()),
          f"K6 instances spill or are missing from the ptxas log: {dots}")

    # -- phase 2: kernels vs plain versions, then times at the paths' shapes ---
    check_kernels(torch)
    times = check_and_time_paper_mesh(torch)
    times["batched"] = check_and_time_batched(torch)
    times["family_256"] = time_family(torch)
    sizes = ([math.prod(s) for s in CHECK_SHAPES] + [math.prod(PAPER_MESH)]
             + [math.prod(JOULE_MESH)])
    record["kernels_vs_plain"] = dict(
        shapes=[list(s) for s in CHECK_SHAPES] + [list(PAPER_MESH)],
        slab_shapes={k: [list(s) for s in v] for k, v in SLAB_SHAPES.items()},
        batches=list(CHECK_BATCHES), batched_shape=[MAIN_NRHS, *JOULE_MESH],
        dot_tol_over_sum_abs={str(n): dot_tol(n) for n in sizes},
        max_abs_err=err, dot_err_over_sum_abs=dot_rel, min_plain_dot_over_tol=dot_signal)
    emit(dict(phase="kernels_vs_plain", **record["kernels_vs_plain"]))
    record["kernel_times"] = times
    emit(dict(phase="kernel_times", shape=list(PAPER_MESH), dtype="bfloat16",
              bf16=times["bf16"], dot_mixed_f32=times["dot_mixed_f32"]))
    emit(dict(phase="kernel_times_batched", shape=[MAIN_NRHS, *JOULE_MESH], dtype="bfloat16",
              **times["batched"]))
    emit(dict(phase="kernel_times_family", shape=list(FAMILY_MESH), dtype="bfloat16",
              accum="bfloat16", **times["family_256"]))
    flat = {**times["bf16"], **times["batched"]}
    emit(dict(phase="redesigned", card=smi, kernels={
        k: dict(ms=flat[k]["ms"], earlier_ms=v, bound_ms=flat[k]["bound_ms"],
                library_ms=flat[k]["library_ms"]) for k, v in EARLIER_MS.items()}))

    # -- phase 3: convergence at the CLI's default problem, f32 ---------------
    # One seed's count moves with the dots' summation order alone (the
    # residual tail is spiky near tol 1e-6), so each seed's gap is held
    # within SEED_GAP and the five seeds' mean within MEAN_GAP, and the same
    # solves with spmd-order dots must match spmd exactly.
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
    gaps = gap_check("fused vs spmd", [r["fused_iterations"] - r["spmd_iterations"]
                                       for r in runs], SEED_GAP, mean=MEAN_GAP)
    matched = [dot_order_matched(torch, seed) for seed in range(PHASE3_SEEDS)]
    record["convergence_f32"] = dict(runs=runs, **gaps, spmd_order_dots=matched)
    emit(dict(phase="convergence_f32", **record["convergence_f32"]))

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
        record["profile"] = profile_paths(torch)
        for prof in record["profile"]:
            emit(prof)

    # -- phase 5: the batched main path, 608^3 x 4 RHS, bf16_mixed ------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res5, counts5 = run_cli(["--mesh", *(str(s) for s in JOULE_MESH), "--nrhs", str(MAIN_NRHS),
                             "--backend", "fused", "--policy", "bf16_mixed", "--tol", "0",
                             "--maxiter", str(MAIN_ITERS)])
    moved = iteration_bytes(JOULE_MESH, 2, nrhs=MAIN_NRHS)
    res5.update(bytes_per_iter=moved, ms_per_rhs_iter=res5["ms_per_iter"] / MAIN_NRHS,
                gb_per_s=moved / (res5["ms_per_iter"] * 1e-3) / 1e9,
                bound_ms_per_iter=moved / PEAK_BYTES_PER_S * 1e3,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts5)
    record["batched"] = res5
    emit(dict(phase="batched", **res5))
    resid = res5["rel_residual"] + res5["true_rel_residual"]
    check(all(math.isfinite(v) and v < 1 for v in resid), f"batched residuals {resid}")
    check(res5["iterations"] == [MAIN_ITERS] * MAIN_NRHS and not any(res5["breakdown"]),
          f"batched path ran {res5['iterations']} iterations (breakdown {res5['breakdown']})")
    check(counts5 == expected_counts(MAIN_ITERS, batched=True),
          f"batched launch counts {counts5} != {expected_counts(MAIN_ITERS, batched=True)}")

    # -- phase 6: batched semantics at the default cell ------------------------
    torch.cuda.empty_cache()
    record["batched_semantics"] = [batched_semantics(torch, seed)
                                   for seed in range(PHASE3_SEEDS)]
    emit(dict(phase="batched_semantics", runs=record["batched_semantics"]))

    # -- phase 7: solve_ref_fused ------------------------------------------------
    ref_default = [ref_fused_default(torch, r["seed"], r["spmd_iterations"], r["fused_iterations"])
                   for r in runs]
    ref_gaps = gap_check("solve_ref_fused vs spmd", [r["iterations"] - r["spmd_iterations"]
                                                     for r in ref_default], SEED_GAP,
                         mean=MEAN_GAP)
    emit(dict(phase="ref_fused_default", runs=ref_default, **ref_gaps))
    torch.cuda.empty_cache()
    res7, counts7 = ref_fused_paper_mesh(torch)
    emit(res7)
    record["ref_fused"] = dict(default=ref_default, paper_mesh=res7)

    # -- phase 8: the solver and preconditioner stack --------------------------
    record["slice"] = phase8(torch, smi, record["paper_mesh"]["ms_per_iter"])

    # -- phase 9: the tuning cache, observability and the performance model ----
    record["phase9"] = phase9(torch, smi, record["paper_mesh"])

    # -- phase 10: the SIMPLE CFD application ----------------------------------
    record["cfd"] = phase10(torch, smi)

    # -- phase 11: the LM serving path -----------------------------------------
    record["lm"] = phase11(torch, smi, profile=args.profile)

    # -- phase 12: the multi-rank solve, four gloo ranks on this card ----------
    record["ranks"] = phase12(torch, smi, record["paper_mesh"],
                              record["cfd"].get("ghia", {}).get("centerline"))

    # -- the kernels line ------------------------------------------------------
    path_counts = {"paper_mesh": counts, "batched": counts5, "ref_fused": counts7}
    all_times = {**times["bf16"], **times["batched"]}
    kernels = []
    for name, (src, replaces, path) in KERNELS.items():
        t = all_times[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=path_counts[path][name], max_abs_err=err[name],
                            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                            bound_by=t["bound_by"], library_ms=t["library_ms"]))
        check(kernels[-1]["launches"] > 0, f"{name}: no launch on its path ({path})")
    record["kernels"] = kernels
    record["failures"] = failures
    record["seconds"] = time.perf_counter() - t_start
    emit(dict(phase="clock", seconds=record["seconds"], failures=len(failures)))
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
