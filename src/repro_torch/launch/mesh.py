"""Rank-mesh construction (counterpart of ``repro/launch/mesh.py``).

The paper maps a 3D ``X x Y x Z`` mesh onto a 2D fabric of processing
elements; here the fabric is a grid of ranks, one GPU each, with axes
``("data", "model")`` carrying X and Y (and ``pod`` slabbing Z when present).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """Axis name -> extent of a rank grid, in axis order."""

    axis_names: tuple[str, ...]
    extents: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.extents))

    @property
    def size(self) -> int:
        n = 1
        for e in self.extents:
            n *= e
        return n


def make_mesh_for_devices(n_devices: int | None = None, *, pods: int = 1) -> RankMesh:
    """Largest near-square 2D (or 3D with pods) grid for ``n_devices`` ranks.

    ``None`` means the ranks of the initialized ``torch.distributed`` group,
    or one rank without it; one rank is the 1x1 grid.
    """
    if n_devices is None:
        import torch.distributed as dist

        n_devices = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    per_pod = n_devices // pods
    x = 1
    for cand in range(int(per_pod ** 0.5), 0, -1):
        if per_pod % cand == 0:
            x = cand
            break
    y = per_pod // x
    if pods > 1:
        return RankMesh(("pod", "data", "model"), (pods, x, y))
    return RankMesh(("data", "model"), (x, y))
