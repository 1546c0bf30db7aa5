"""27-point box stencil cells: the full-neighborhood cube workload.

The box27 shape (all 26 neighbors of the 3x3x3 cube) is the stress case
for the halo machinery — unlike star stencils it reads edge and corner
halo values, which the halo exchange (``core/halo.py``) supplies through
the corner-carrying sequential exchange.  It shows up in trilinear FEM
mass/stiffness matrices, 27-point HPCG-style smoothers, and is one of the
kernels of Belli & De Sensi's *Stencil Computations on Cerebras Wafer-Scale
Engine* study of this paper's hardware lineage.

The port's copy of ``repro/configs/stencil_box27.py``, with the same cells.
"""

from __future__ import annotations

from repro_torch.configs.stencil_star25_seismic import StencilFamilyCell

BOX27_CELLS = {
    "box_smoke": StencilFamilyCell("box_smoke", (24, 24, 16), "box27",
                                   policy="f32", problem="random"),
    "box_chip": StencilFamilyCell("box_chip", (96, 96, 256), "box27",
                                  problem="random"),
    # full-neighborhood SPD smoother cell: CG through the Pallas-fused
    # backend (the box27 corner-halo path feeding the fused kernels)
    "box_cg_pallas": StencilFamilyCell("box_cg_pallas", (24, 24, 16), "box27",
                                       policy="f32", problem="poisson",
                                       solver="cg", backend="pallas"),
}


def ops_per_meshpoint_box27() -> dict:
    """Per-iteration per-meshpoint counts, Table-I style, for box27."""
    return {
        "matvec_hp_add": 52, "matvec_hp_mul": 52,
        "dot_hp_mul": 4, "dot_sp_add": 4,
        "axpy_hp_add": 6, "axpy_hp_mul": 6,
        "total": 124,
    }
