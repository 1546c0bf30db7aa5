"""Rank-mesh construction (counterpart of ``repro/launch/mesh.py``).

The paper maps a 3D ``X x Y x Z`` mesh onto a 2D fabric of processing
elements; here the fabric is a grid of ranks with axes ``("data",
"model")`` carrying X and Y (and ``pod`` slabbing Z when present).  Ranks
are laid out row-major over the axes, in the JAX mesh's device order: rank
``(pod * data_extent + data) * model_extent + model``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """Axis name -> extent of a rank grid, in axis order, and the rank of
    the process holding this view of it."""

    axis_names: tuple[str, ...]
    extents: tuple[int, ...]
    rank: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.extents))

    @property
    def size(self) -> int:
        n = 1
        for e in self.extents:
            n *= e
        return n

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index along each axis."""
        out, rest = {}, self.rank
        for name, e in reversed(list(zip(self.axis_names, self.extents))):
            out[name] = rest % e
            rest //= e
        return {name: out[name] for name in self.axis_names}


def _world() -> tuple[int, int]:
    """(world size, rank) of the running process group, or (1, 0)."""
    from repro_torch.core import dist

    return dist.world_size(), dist.rank()


def make_mesh_for_devices(n_devices: int | None = None, *, pods: int = 1) -> RankMesh:
    """Largest near-square 2D (or 3D with pods) grid for ``n_devices`` ranks.

    ``None`` means the ranks of the initialized ``torch.distributed`` group,
    or one rank without it; one rank is the 1x1 grid.  The mesh carries this
    process's rank when the group has ``n_devices`` ranks.
    """
    world, rank = _world()
    if n_devices is None:
        n_devices = world
    per_pod = n_devices // pods
    x = 1
    for cand in range(int(per_pod ** 0.5), 0, -1):
        if per_pod % cand == 0:
            x = cand
            break
    y = per_pod // x
    rank = rank if world == n_devices else 0
    if pods > 1:
        return RankMesh(("pod", "data", "model"), (pods, x, y), rank)
    return RankMesh(("data", "model"), (x, y), rank)


def fabric_shape(mesh: RankMesh) -> tuple[int, int, int]:
    """(pods, fabric_x, fabric_y) of a rank mesh."""
    ax = mesh.shape
    return ax.get("pod", 1), ax["data"], ax["model"]
