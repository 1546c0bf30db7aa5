"""Seismic-RTM stencil cells: the 25-point star through the solver stack.

The 25-point star (8th-order finite differences, radius 4 per axis) is the
stencil of the follow-on work the paper's §VII points toward: Jacquelin,
Araya-Polo & Meng, *Massively scalable stencil algorithm*, whose workload is
explicit time stepping of the acoustic wave equation, with no solve; the
port runs that workload in ``core/wave.py``.  These cells are the repo's own
construction instead: the star as an implicit-timestep system ``I - theta
L_8`` (``stencil.high_order_star``, its dominance chosen here) solved with
this repo's BiCGStab stack.

The meshes mirror the scaling ladder of that paper's experiments at sizes
this repo's dry-run machinery can lower: a smoke cell, a single-chip-class
volume, and the full RTM-class volume (1008^2 x 352, the "n1008" grid
family), all Z-pencil friendly.

The port's copy of ``repro/configs/stencil_star25_seismic.py``, with the
same cells.  The ``backend`` and ``autotune`` fields keep the JAX package's
values (its ``pallas`` backend is this package's ``fused``), so the two
tables compare cell by cell.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StencilFamilyCell:
    """One named stencil-family workload.

    A cell pins the full solve configuration: shape x stencil x precision
    plus the solver-stack choices of the operator/solver/precond layers
    (``launch.solve --solver/--backend/--precond``).
    """

    name: str
    mesh_shape: tuple[int, int, int]     # problem mesh (X, Y, Z)
    stencil: str                         # key into core.stencil.SPECS
    policy: str = "bf16_mixed"
    problem: str = "seismic"             # launch.solve --problem value
    solver: str = "bicgstab"             # key into core.solvers.SOLVERS
    backend: str = "spmd"                # key into core.operator.BACKENDS
    precond: str = "none"                # core.precond.PRECONDS
    cheb_degree: int = 3                 # when precond == "chebyshev"
    schedule: str = "overlap"            # core.comm.SCHEDULES
    autotune: bool = False               # the JAX package's value; the port's
    #                                      kernel has one launch plan
    nrhs: int = 1                        # right-hand sides per block solve
    #                                      (launch.solve --nrhs): >1 batches
    #                                      the whole Krylov iteration — halo
    #                                      slabs of all RHS per ppermute, one
    #                                      AllReduce of [k, B] per sync point


SEISMIC_CELLS = {
    "rtm_smoke": StencilFamilyCell("rtm_smoke", (24, 24, 16), "star25",
                                   policy="f32"),
    "rtm_chip": StencilFamilyCell("rtm_chip", (96, 96, 352), "star25"),
    "rtm_n1008": StencilFamilyCell("rtm_n1008", (1008, 1008, 352), "star25"),
    # the preconditioned implicit-timestep variant: same operator, the
    # Chebyshev right-precondition cuts the AllReduce-bearing outer
    # iterations at the cost of local-only polynomial SpMVs
    "rtm_chip_cheb": StencilFamilyCell("rtm_chip_cheb", (96, 96, 352),
                                       "star25", precond="chebyshev"),
    # latency-lean variant for the large fabric: deep halos overlapped
    # under the wide star's interior, one AllReduce per iteration
    "rtm_n1008_pipelined": StencilFamilyCell(
        "rtm_n1008_pipelined", (1008, 1008, 352), "star25",
        solver="pipelined_bicgstab", schedule="overlap"),
    # the JAX package's autotuned Pallas-backend variant (the port's fused
    # backend runs it with the kernel's one launch plan)
    "rtm_chip_tuned": StencilFamilyCell("rtm_chip_tuned", (96, 96, 352),
                                        "star25", backend="pallas",
                                        autotune=True),
}


#: Batched (many-RHS) workload cells, kept out of SEISMIC_CELLS: they are
#: not star25 workloads (the ops-table assertions over SEISMIC_CELLS assume
#: the seismic stencil) but the batched-solve benchmark's configuration
#: surface.  ``batched_poisson`` is the cell ``benchmarks/batched_solve.py``
#: sweeps over B.
BATCHED_CELLS = {
    "batched_poisson": StencilFamilyCell(
        "batched_poisson", (24, 24, 16), "star7", policy="f32",
        problem="poisson", solver="pipelined_bicgstab", schedule="overlap",
        nrhs=8),
}


def ops_per_meshpoint_star25() -> dict:
    """Per-iteration per-meshpoint counts, Table-I style, for star25.

    The SpMV term scales with the 24 off-diagonals (48 ops/SpMV); the dot
    and AXPY terms are shape-independent (8 + 12, as in the paper).
    """
    return {
        "matvec_hp_add": 48, "matvec_hp_mul": 48,
        "dot_hp_mul": 4, "dot_sp_add": 4,
        "axpy_hp_add": 6, "axpy_hp_mul": 6,
        "total": 116,
    }
