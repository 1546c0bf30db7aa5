"""The stencil kernel's launch plan (``kernels/stencil_nd/kernel.py:launch_plan``).

The CUDA kernel runs only on the card; the plan that cuts its launches into
(y, z) tiles, x segments and right-hand-side chunks is plain Python, checked
here for every family spec, both storage dtypes, B in {1, 3, 4} and the
shapes the kernel meets: the paths' blocks, ``chip_smoke.py``'s check
shapes and the overlap schedule's ring slabs.  The SpMV+dot kernel (K6,
``csrc/stencil7_dot.cu``) takes the star7 plan for one RHS, and sizes its
dot partials by the plan's block count.
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import stencil  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil_nd.kernel import FAMILY, SMEM_BYTES, launch_plan  # noqa: E402

SHAPES = [(608, 608, 1536), (608, 608, 608),                        # the paths
          (256, 256, 256), (48, 48, 32), (37, 29, 17),              # check shapes
          (1, 29, 17), (37, 1, 17), (37, 29, 1), (4, 29, 17)]       # ring slabs


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("nb", [1, 3, 4])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("specname", ["star7", "star13", "star25", "box27"])
def test_launch_plan_covers_block_within_limits(specname, itemsize, nb, shape):
    spec = stencil.get_spec(specname)
    bx, by, z = shape
    p = launch_plan(shape, nb, spec.n_offsets, spec.radius, itemsize)
    # the compiled tile: 16 rows, 16 threads along z on one 16-B vector each
    assert (p.ty, p.tz) == (16, 16 * (16 // itemsize))
    # tiles, segments and chunks cover the block and the batch exactly
    assert (p.tiles_y - 1) * p.ty < by <= p.tiles_y * p.ty
    assert (p.tiles_z - 1) * p.tz < z <= p.tiles_z * p.tz
    assert 1 <= p.seg_len <= bx
    assert (p.segments - 1) * p.seg_len < bx <= p.segments * p.seg_len
    assert p.chunk >= 1 and (p.chunks - 1) * p.chunk < nb <= p.chunks * p.chunk
    assert p.chunk <= FAMILY[(spec.n_offsets, spec.radius)][1]
    assert nb > 1 or p.chunk == 1
    # the shared-memory ring fits one block, and the grid CUDA's limits
    assert 0 < p.smem_bytes <= SMEM_BYTES
    gx, gy, gz = p.grid
    assert 1 <= gx <= 2 ** 31 - 1 and 1 <= gy <= 65535 and 1 <= gz <= 65535


def test_launch_plan_takes_only_family_specs():
    with pytest.raises(ValueError, match="family specs"):
        launch_plan((8, 8, 8), 1, 6, 2, 2)
    with pytest.raises(ValueError, match="bf16 or f32"):
        launch_plan((8, 8, 8), 1, 6, 1, 8)


K6_SHAPES = [(608, 608, 1536), (48, 48, 32), (37, 29, 17),          # solve_ref_fused, checks
             (1, 29, 17), (37, 1, 17), (37, 29, 1), (3, 7, 17)]     # thin blocks


@pytest.mark.parametrize("shape", K6_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_k6_plan_one_partial_per_block(itemsize, shape):
    """K6's grid: (y, z) tiles by x segments, one RHS, each block with
    planes to march and one partial per dot; a ring of 4 planes of one RHS
    leaves room on an SM for the blocks K6's register budget is set for
    (``kMinBlocksDot``)."""
    bx, by, z = shape
    p = launch_plan(shape, 1, 6, 1, itemsize)
    vz = 16 // itemsize
    assert p.chunk == p.chunks == 1 and p.grid[2] == 1
    assert p.blocks == p.grid[0] * p.grid[1] == (-(-by // p.ty)) * (-(-z // p.tz)) * (
        -(-bx // p.seg_len))
    assert (p.segments - 1) * p.seg_len < bx          # no segment without planes
    assert p.smem_bytes == 4 * (p.ty + 2) * (p.tz + 2 * vz) * itemsize <= 48 * 1024
    min_blocks = re.search(r"constexpr int kMinBlocksDot = (\d+);",
                           (_build.CSRC / "stencil7_dot.cu").read_text())
    assert min_blocks and int(min_blocks.group(1)) * (p.smem_bytes + 1024) <= 228 * 1024
    if shape == (608, 608, 1536):                      # the card filled several times over
        assert p.blocks >= 4 * 132 and p.blocks <= 2 ** 31 - 1
