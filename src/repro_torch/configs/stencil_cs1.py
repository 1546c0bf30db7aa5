"""The paper's own problem configurations (stencil BiCGStab cells).

The port's copy of ``repro/configs/stencil_cs1.py``.  ``cs1_paper`` is the
measured configuration of §V: a 600 x 595 x 1536 mesh padded to 608 x 608
(the CS-1 ran 602 x 595 tiles).  ``joule_600`` / ``joule_370`` are the
strong-scaling comparison meshes of Figs. 7-8.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StencilCell:
    name: str
    mesh_shape: tuple[int, int, int]      # padded problem mesh (X, Y, Z)
    true_shape: tuple[int, int, int]      # the paper's unpadded mesh
    policy: str = "bf16_mixed"            # paper: fp16 + f32 reductions
    kind: str = "nonsymmetric"            # problem generator


STENCIL_CELLS = {
    "cs1_paper": StencilCell("cs1_paper", (608, 608, 1536), (600, 595, 1536)),
    "joule_600": StencilCell("joule_600", (608, 608, 608), (600, 600, 600)),
    "joule_370": StencilCell("joule_370", (384, 384, 370), (370, 370, 370)),
    "smoke": StencilCell("smoke", (16, 16, 8), (16, 16, 8), policy="f32"),
}


def ops_per_meshpoint() -> dict:
    """Paper Table I (mixed column): per iteration per meshpoint."""
    return {
        "matvec_hp_add": 12, "matvec_hp_mul": 12,
        "dot_hp_mul": 4, "dot_sp_add": 4,
        "axpy_hp_add": 6, "axpy_hp_mul": 6,
        "total": 44,
    }
