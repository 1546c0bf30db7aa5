"""Analytic performance model for the distributed BiCGStab iteration.

Counterpart of ``repro/core/perfmodel.py``: the paper's §V model (iteration
time = compute at the vector rate + memory at the device-memory rate +
communication at the fabric rate, the AllReduce adding a diameter-bound
latency), with the same three terms and the same per-solver collective
structure, and NVIDIA H100 SXM figures in place of the TPU's:

  t_compute    = 44 flops/pt * pts_per_chip / PEAK_FLOPS
  t_memory     = words/pt * itemsize * pts_per_chip / HBM_BW
                 (words/pt = 42: 2 SpMV sweeps reading 6 diagonals + iterate
                  + writing result, 6 AXPY r/w sweeps, 4 dot reads)
  t_collective = halo faces (4 or 6 per SpMV, 2 SpMV) / LINK_BW
                 + n_reductions * allreduce_latency(mesh)

The iteration is bound by max(compute, memory) + collective; under
``schedule="overlap"`` the halos hide under the interior apply, the blocking
reductions cannot.  :func:`predict_crossover` locates the fabric size where
one configuration (a pipelined solver, a schedule) overtakes another.

There is no measured H100 figure for one hop of an AllReduce yet, so
:func:`allreduce_latency` is 0 on one chip and needs the latency as an
argument on more: a multi-chip prediction names where its latency came from.
"""

from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 SXM, NVIDIA's data sheet.
#: device-memory bandwidth, bytes/s (data sheet, 700 W, not measured)
HBM_BW = 3.35e12
#: float32 rate outside the tensor cores, flop/s: the port's stencil and
#: vector kernels issue plain f32 (and bf16) arithmetic on the CUDA cores and
#: no tensor-core instruction, so the tensor cores' rates do not bound them
#: (data sheet, 700 W, not measured)
PEAK_FLOPS = 67e12
#: NVLink, bytes/s each way to the other cards of the host (data sheet,
#: 700 W, not measured)
LINK_BW = 450e9
FLOPS_PER_PT = 44.0
WORDS_PER_PT = 42.0


@dataclasses.dataclass(frozen=True)
class SolverComm:
    """Per-iteration communication/traffic structure of a registered solver.

    ``words_per_pt`` follows the §IV accounting style: SpMV sweeps read the
    coefficient diagonals + iterate and write the result (8 words each for
    star7), each AXPY-class update reads/writes 3 words, each dot reads 2.
    """

    n_spmv: int                  # SpMVs (= halo exchanges) per iteration
    reductions_fused: int        # AllReduces per iteration, fused schedule
    reductions_separate: int     # ... one per dot (paper-faithful)
    words_per_pt: float          # device-memory words per meshpoint per iteration


#: solver name (core.solvers.SOLVERS) -> its collective structure.
SOLVER_COMMS = {
    # 2 SpMV (16) + 6 AXPY (18) + 4 dot reads (8) = 42 (§IV's 10-vector set)
    "bicgstab": SolverComm(2, 3, 5, 42.0),
    # 2 SpMV (16) + 9 AXPY (27) + 12 dot reads (24) = 67: the memory price
    # of the single-reduction reformulation (carried A-images z, t)
    "pipelined_bicgstab": SolverComm(2, 1, 12, 67.0),
    # 1 SpMV (8) + 3 AXPY (9) + 2 dot reads (4) = 21
    "cg": SolverComm(1, 2, 3, 21.0),
    # 1 SpMV (8) + 6 AXPY (18) + 2 dot reads (4) = 30 (Ghysels-Vanroose
    # z/s/p recurrence triple)
    "pipelined_cg": SolverComm(1, 1, 2, 30.0),
}


def allreduce_latency(px: int, py: int, pz: int = 1, *,
                      hop_latency_s: float | None = None) -> float:
    """Latency-optimal AllReduce on a (px, py[, pz]) torus: ~2x diameter hops
    (reduce + broadcast), the paper's Fig. 6 scheme.

    One chip reduces nothing (0 s).  On more, ``hop_latency_s`` is required:
    the port has no measured H100 hop latency, and a model that guessed one
    would print a number nobody measured."""
    if px * py * pz == 1:
        return 0.0
    if hop_latency_s is None:
        raise ValueError(f"allreduce_latency on a {px}x{py}x{pz} fabric needs hop_latency_s: "
                         f"no AllReduce latency has been measured on H100 cards")
    diameter = (px // 2) + (py // 2) + (pz // 2)
    return 2.0 * diameter * hop_latency_s


def iteration_time_model(mesh_shape, chips: int, *, itemsize: int = 2,
                         fused_reductions: bool = True, fused_sweeps: bool = False,
                         solver: str = "bicgstab", schedule: str = "overlap",
                         pods: int = 1, hop_latency_s: float | None = None) -> dict:
    """Predicted Krylov iteration time for an X*Y*Z mesh on ``chips`` cards.

    ``solver`` selects the per-iteration collective structure from
    :data:`SOLVER_COMMS`; ``schedule`` chooses whether the halo transfers
    hide under the interior apply (``overlap``) or serialize before it
    (``blocking``).  ``fused_sweeps`` models the fused-iteration kernels
    (BiCGStab words/pt 42 -> 28: SpMV+dot and AXPY+dot single passes).
    ``hop_latency_s`` is passed to :func:`allreduce_latency`.
    """
    comm = SOLVER_COMMS[solver]
    X, Y, Z = mesh_shape
    per_pod = chips // pods
    px = py = int(math.sqrt(per_pod))
    pts_chip = X * Y * Z / chips
    words = comm.words_per_pt
    if fused_sweeps and solver == "bicgstab":
        words = 28.0

    t_comp = FLOPS_PER_PT * pts_chip / PEAK_FLOPS
    t_mem = words * itemsize * pts_chip / HBM_BW

    # halos: n_spmv x 4 faces of (block_y*Z or block_x*Z) + pod Z-faces
    bx, by = X / px, Y / py
    face_words = 2 * ((bx + by) * (Z / pods)) * 2  # both directions, per spmv
    if pods > 1:
        face_words += 2 * (bx * by) * 2
    t_halo = comm.n_spmv * face_words * itemsize / LINK_BW
    n_red = comm.reductions_fused if fused_reductions else comm.reductions_separate
    t_red = n_red * allreduce_latency(px, py, pods, hop_latency_s=hop_latency_s)

    t_interior = max(t_comp, t_mem)
    if schedule == "overlap":
        # halos hide under the interior apply; only the excess is exposed
        t_halo_exposed = max(0.0, t_halo - t_interior)
    elif schedule == "blocking":
        t_halo_exposed = t_halo
    else:
        raise KeyError(f"unknown schedule {schedule!r}; have ['blocking', 'overlap']")
    t_iter = t_interior + t_red + t_halo_exposed
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_halo_s": t_halo,
        "t_halo_exposed_s": t_halo_exposed,
        "t_reduce_s": t_red,
        "t_iter_s": t_iter,
        "n_reductions": n_red,
        "bound": "memory" if t_mem >= t_comp else "compute",
    }


def predict_crossover(mesh_shape, base: dict, alt: dict,
                      chip_counts=(4, 16, 64, 256, 1024, 4096, 16384, 65536),
                      **common) -> dict:
    """First fabric size where model config ``alt`` beats ``base``.

    ``base``/``alt`` are keyword overrides for :func:`iteration_time_model`
    (e.g. ``{"solver": "bicgstab"}`` vs ``{"solver": "pipelined_bicgstab"}``);
    ``common`` goes to both (``hop_latency_s`` among it, since every count
    here is more than one chip).
    """
    rows = []
    crossover = None
    for chips in chip_counts:
        t_base = iteration_time_model(mesh_shape, chips, **common, **base)
        t_alt = iteration_time_model(mesh_shape, chips, **common, **alt)
        rows.append({"chips": chips, "t_base_s": t_base["t_iter_s"],
                     "t_alt_s": t_alt["t_iter_s"]})
        if crossover is None and t_alt["t_iter_s"] < t_base["t_iter_s"]:
            crossover = chips
    return {"base": base, "alt": alt, "mesh_shape": list(mesh_shape),
            "rows": rows, "crossover_chips": crossover}


def mfix_timesteps_per_second(mesh_shape, chips: int, *, simple_iters: int = 15,
                              mom_solver_iters: int = 5, cont_solver_iters: int = 20,
                              hop_latency_s: float | None = None) -> float:
    """Paper §VI-A projection: SIMPLE wall time from the iteration model +
    Table II's matrix-forming cost (~60 memory words per meshpoint per
    SIMPLE iteration at the device-memory rate)."""
    solve_iters = simple_iters * (3 * mom_solver_iters + cont_solver_iters)
    t_iter = iteration_time_model(mesh_shape, chips, hop_latency_s=hop_latency_s)["t_iter_s"]
    # forming: Table II total 165-364 cycles/pt -> ~60 memory words/pt
    X, Y, Z = mesh_shape
    t_form = simple_iters * 4 * 60 * 2 * (X * Y * Z / chips) / HBM_BW
    return 1.0 / (solve_iters * t_iter + t_form)
