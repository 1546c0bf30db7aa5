"""The rule of the stencil kernel's launch plan (``kernels/stencil_nd/kernel.py:
launch_plan``), the one place that decides how a K1 launch is cut.

``tests/test_torch_stencil_plan.py`` checks that every plan covers its block
within CUDA's limits; here the plan is held to its rule, written as a search
rather than the closed form the kernel uses: the RHS chunk is 1 for one RHS
and the family's maximum otherwise, and the x segment is the shortest one, no
shorter than ``MIN_SEGMENT`` (or the block), that cuts the block into no more
segments than ``TARGET_BLOCKS`` asks of each (tile, chunk).  The axpy form
(one RHS) is the same plan with one more plane of shared memory, within the
limits at every family spec and shape.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread per test process (tests/_torch_port.py)

from repro_torch.core import stencil  # noqa: E402
from repro_torch.kernels.stencil_nd.kernel import (  # noqa: E402
    FAMILY, MIN_SEGMENT, SMEM_BYTES, TARGET_BLOCKS, launch_plan,
)

SPECS = ["star7", "star13", "star25", "box27"]
#: the paths' blocks, check shapes and ring slabs
SHAPES = [(608, 608, 1536), (608, 608, 608), (256, 256, 256), (48, 48, 32), (37, 29, 17),
          (1, 29, 17), (37, 1, 17), (37, 29, 1), (4, 29, 17)]


def _ring_bytes(spec, itemsize: int, rhs: int, extra_planes: int = 0) -> int:
    """Shared memory of a ring of 2r+2 planes per RHS (plus ``extra_planes``),
    each (16 + 2r) rows at a pitch of the tile's z plus a 16-B vector each side."""
    vz = 16 // itemsize
    plane = (16 + 2 * spec.radius) * (16 * vz + 2 * vz) * itemsize
    return (rhs * (2 * spec.radius + 2) + extra_planes) * plane


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("specname", SPECS)
def test_default_plan_rule(specname, itemsize):
    spec = stencil.get_spec(specname)
    max_chunk = FAMILY[(spec.n_offsets, spec.radius)][1]
    for shape in SHAPES:
        bx, by, z = shape
        for nb in (1, 2, 3, 4):
            p = launch_plan(shape, nb, spec.n_offsets, spec.radius, itemsize)
            assert p.chunk == (1 if nb == 1 else max_chunk), (shape, nb)
            assert p.chunks == -(-nb // p.chunk)
            assert (p.tiles_y, p.tiles_z) == (-(-by // p.ty), -(-z // p.tz))
            per_segment = p.tiles_y * p.tiles_z * p.chunks
            asked = -(-TARGET_BLOCKS // per_segment)
            shortest = next(s for s in range(min(bx, MIN_SEGMENT), bx + 1)
                            if -(-bx // s) <= asked)
            assert p.seg_len == shortest, (shape, nb, p)
            assert p.seg_len >= min(bx, MIN_SEGMENT)
            assert p.blocks < TARGET_BLOCKS + per_segment or p.seg_len == min(bx, MIN_SEGMENT)
            assert p.smem_bytes == _ring_bytes(spec, itemsize, min(p.chunk, nb))


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("specname", SPECS)
def test_axpy_plan_within_limits(specname, itemsize):
    """One RHS: the bare form's tiles and segments, shared memory one plane
    of ``s`` more and within a block's share, the grid within CUDA's."""
    spec = stencil.get_spec(specname)
    for shape in SHAPES:
        k1 = launch_plan(shape, 1, spec.n_offsets, spec.radius, itemsize)
        ax = launch_plan(shape, 1, spec.n_offsets, spec.radius, itemsize, axpy=True)
        assert dataclasses.replace(ax, smem_bytes=k1.smem_bytes) == k1, shape
        assert ax.smem_bytes == _ring_bytes(spec, itemsize, 1, extra_planes=1) <= SMEM_BYTES
        gx, gy, gz = ax.grid
        assert 1 <= gx <= 2 ** 31 - 1 and 1 <= gy <= 65535 and gz == 1
        assert (ax.segments - 1) * ax.seg_len < shape[0] <= ax.segments * ax.seg_len
