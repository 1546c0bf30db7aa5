"""The overlap schedule's split ring form (``kernels/stencil_nd/ops.py:
ring_patch_apply``): the stencil kernel on the bare block, then one launch
per boundary ring slab of the exchanged block.

It is held bit for bit to one launch over the whole exchanged r-padded block
(the blocking schedule's form), and to the JAX package's one-pass apply on
the same block.  The exchange is a stand-in with no collective
(``_torch_port.synthetic_exchange``); on CPU tensors the kernel wrappers take
their plain versions.  The four-rank exchange is
``tests/test_torch_dist_halo.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import assert_bitwise, assert_ulp_close, synthetic_exchange, to_np  # noqa: E402
from repro.core import comm as jax_comm  # noqa: E402
from repro.core import stencil as jst  # noqa: E402
from repro.core import tuning as jax_tuning  # noqa: E402
from repro.kernels.stencil_nd.fused import fused_ring_apply as jax_fused_ring_apply  # noqa: E402
from repro_torch.core import comm, stencil  # noqa: E402
from repro_torch.core.halo import FabricAxes  # noqa: E402
from repro_torch.kernels.stencil_nd.ops import _kernel, ring_patch_apply  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
#: x and y split: the overlap schedule patches four ring slabs
FAB = FabricAxes(nx=2, ny=2)
#: one split axis at a time, z on a third fabric axis
ONE_AXIS = {"x": FabricAxes(nx=2), "y": FabricAxes(ny=2), "z": FabricAxes(z="pod", nz=2)}


def _cell(spec, dtype, shape, nb=0, seed=0):
    """Coefficient fields uniform in +-0.2 and a standard normal iterate
    (``nb`` right-hand sides, or one unbatched block), in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    cfs = [(torch.rand(shape, generator=gen) * 0.4 - 0.2).to(dtype) for _ in spec.offsets]
    v = torch.randn(((nb,) if nb else ()) + shape, generator=gen).to(dtype)
    return cfs, v, gen


def _forms(ex, v, cfs, spec, fabric, dtype):
    """(split, whole): the kernel on the bare block with the ring slabs
    patched from the exchange, and one launch over the exchanged block."""
    launch = _kernel(ex.n_batch)
    whole = launch(ex.padded, cfs, spec.offsets, radius=spec.radius, accum_dtype=dtype)
    u = launch(v, cfs, spec.offsets, radius=spec.radius, accum_dtype=dtype)
    return ring_patch_apply(ex, cfs, spec, u, fabric, accum_dtype=dtype), whole


def test_synthetic_exchange_layout():
    spec = stencil.STAR7
    v = torch.randn((2, 6, 8, 8), generator=torch.Generator().manual_seed(0))
    ex = synthetic_exchange(v, spec, FAB)
    r = spec.radius
    assert ex.n_batch == 1 and ex.shape == (6, 8, 8)
    assert_bitwise(ex.padded[:, r:-r, r:-r, r:-r], v)
    assert ex.padded[:, :r, r:-r, r:-r].abs().sum() > 0          # x halo filled
    assert ex.padded[:, r:-r, :r, r:-r].abs().sum() > 0          # y halo filled
    assert not ex.padded[:, r:-r, r:-r, :r].any()                # unsplit z halo zero


@pytest.mark.parametrize("specname", ["star7", "star25", "box27"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nb", [0, 2], ids=["unbatched", "batched"])
def test_split_ring_bitwise_identical_to_one_padded_launch(specname, dtype, nb):
    """A cell off the ring reads no halo value, so its sum is the same over
    the bare and the exchanged block; a ring cell sums exactly the terms
    the patch launch sums from the same slab."""
    spec = stencil.get_spec(specname)
    shape = (8, 8, 8) if specname == "star25" else (6, 8, 8)
    cfs, v, gen = _cell(spec, dtype, shape, nb)
    ex = synthetic_exchange(v, spec, FAB, generator=gen)
    assert len(comm.boundary_regions(ex.shape, FAB, spec.radius)) == 4
    split, whole = _forms(ex, v, cfs, spec, FAB, dtype)
    assert split.dtype == whole.dtype == dtype
    assert_bitwise(split, whole)


@pytest.mark.parametrize("specname", ["star7", "star13", "box27"])
@pytest.mark.parametrize("axis", sorted(ONE_AXIS))
def test_split_ring_on_one_split_axis(axis, specname):
    """One split axis: two ring slabs, the other halos zero (box27 reads
    their edges and corners), bit for bit one padded launch."""
    spec = stencil.get_spec(specname)
    fabric = ONE_AXIS[axis]
    cfs, v, gen = _cell(spec, F32, (6, 7, 9), seed=5)
    ex = synthetic_exchange(v, spec, fabric, generator=gen)
    assert len(comm.boundary_regions(ex.shape, fabric, spec.radius)) == 2
    split, whole = _forms(ex, v, cfs, spec, fabric, F32)
    assert_bitwise(split, whole)


@pytest.mark.parametrize("specname", ["star7", "star25", "box27"])
def test_split_ring_matches_the_reference(specname):
    """The port's split form against the JAX package's one-pass apply
    (Pallas, interpret mode) on the same exchanged block, f32: within 2 ulp
    of each sum's largest term (XLA contracts the reference's multiply-adds
    into FMAs; the port does not)."""
    spec = stencil.get_spec(specname)
    shape = (8, 8, 8) if specname == "star25" else (6, 8, 8)
    cfs, v, gen = _cell(spec, F32, shape, seed=3)
    ex = synthetic_exchange(v, spec, FAB, generator=gen)
    got, _ = _forms(ex, v, cfs, spec, FAB, F32)
    vp, cfn = to_np(ex.padded), [to_np(c) for c in cfs]
    jex = jax_comm.HaloExchange(padded=jnp.asarray(vp), radius=spec.radius, shape=shape)
    want = jax_fused_ring_apply(jex, [jnp.asarray(c) for c in cfn], jst.get_spec(specname),
                                jax_tuning.KernelConfig(block=shape[:2], zc=shape[2]),
                                interpret=True)
    r = spec.radius
    scale = np.abs(vp[r:-r, r:-r, r:-r]).astype(np.float64)
    for c, off in zip(cfn, spec.offsets):
        win = vp[tuple(slice(r + o, r + o + n) for o, n in zip(off, shape))]
        scale = np.maximum(scale, np.abs(c * win))
    assert_ulp_close(got, np.asarray(jax.device_get(want)), scale * spec.n_points)
