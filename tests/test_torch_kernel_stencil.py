"""Port parity for the stencil kernel's plain version (K1) against the JAX
package's Pallas kernel ``stencil_nd_pallas`` in interpret mode, plus the
port's own apply-path invariants.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against this plain version bit for bit); here the wrapper sees CPU tensors
and takes the plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import assert_bitwise, assert_ulp_close, carry_coeffs, to_np, to_t  # noqa: E402
from repro.core import stencil as jst  # noqa: E402
from repro.kernels.stencil_nd.kernel import stencil_nd_pallas  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import stencil as tst  # noqa: E402
from repro_torch.core.comm import BLOCKING, OVERLAP  # noqa: E402
from repro_torch.core.halo import FabricAxes, local_apply  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.stencil_nd import (  # noqa: E402
    fused_local_apply, stencil_apply, stencil_nd_padded_ref, stencil_nd_ref,
)
from repro_torch.kernels.stencil_nd.kernel import stencil_nd  # noqa: E402

_J = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_T = {"f32": torch.float32, "bf16": torch.bfloat16}
DTYPES = [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32")]
CASES = ([(s, (8, 8, 8), d) for s in ("star7", "star13", "star25", "box27") for d in DTYPES]
         + [(s, (6, 5, 8), d) for s in ("star7", "box27") for d in DTYPES])


def _inputs(spec, shape, storage, seed=0):
    rng = np.random.default_rng(seed)
    v = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(_J[storage])
    cfs = [jnp.asarray((rng.standard_normal(shape) * 0.2).astype(np.float32)).astype(_J[storage])
           for _ in spec.offsets]
    return jnp.pad(v, spec.radius), cfs


@pytest.mark.parametrize("specname,shape,dtypes", CASES)
def test_plain_version_matches_pallas_kernel(specname, shape, dtypes):
    """f32: within 2 ulp of each point's largest term (XLA contracts the
    multiply-adds into FMAs, the kernel and its plain version never do);
    bf16 storage: bitwise, with bf16 or f32 accumulation."""
    storage, accum = dtypes
    spec = jst.get_spec(specname)
    vp, cfs = _inputs(spec, shape, storage)
    uj = stencil_nd_pallas(vp, cfs, spec.offsets, radius=spec.radius, zc=shape[2],
                           accum_dtype=_J[accum])
    reset_launch_counts()
    ut = stencil_nd(to_t(vp), [to_t(c) for c in cfs], spec.offsets, radius=spec.radius,
                    accum_dtype=_T[accum])
    assert launch_counts()["stencil_nd"] == 0          # CPU tensors: plain version
    assert ut.dtype == _T[storage] and tuple(ut.shape) == shape
    if storage == "bf16":
        assert_bitwise(ut, uj)
        return
    r = spec.radius
    vpn = to_np(vp).astype(np.float64)
    win = lambda off: vpn[tuple(slice(r + o, r + o + n) for o, n in zip(off, shape))]
    scale = np.abs(win((0, 0, 0))) + sum(np.abs(to_np(c) * win(off))
                                         for c, off in zip(cfs, spec.offsets))
    assert_ulp_close(ut, uj, scale)


@pytest.mark.parametrize("specname", ["star7", "star25", "box27"])
@pytest.mark.parametrize("storage,accum", DTYPES)
def test_padded_and_unpadded_plain_versions_agree(specname, storage, accum):
    """The kernel-layout plain version equals the JAX-ref counterpart on the
    zero-padded block bitwise (same terms, same order)."""
    spec = tst.get_spec(specname)
    g = torch.Generator().manual_seed(1)
    v = torch.randn((7, 6, 9), generator=g).to(_T[storage])
    cfs = [(0.2 * torch.randn((7, 6, 9), generator=g)).to(_T[storage]) for _ in spec.offsets]
    r = spec.radius
    a = stencil_nd_padded_ref(torch.nn.functional.pad(v, (r, r) * 3), cfs, spec.offsets,
                              radius=r, accum_dtype=_T[accum])
    b = stencil_nd_ref(v, cfs, spec.offsets, accum_dtype=_T[accum])
    assert_bitwise(a, b)


@pytest.mark.parametrize("specname", ["star7", "box27"])
def test_stencil_apply_matches_core_apply(specname):
    """ops.stencil_apply (zero-Dirichlet block) is the port's apply_ref bitwise."""
    spec = tst.get_spec(specname)
    cf = tst.random_nonsymmetric(torch.Generator().manual_seed(2), (5, 6, 7), spec=spec)
    v = torch.randn((5, 6, 7), generator=torch.Generator().manual_seed(3))
    assert_bitwise(stencil_apply(cf, v), tst.apply_ref(cf, v))


@pytest.mark.parametrize("policy", ["f32", "bf16_mixed", "bf16_pure"])
@pytest.mark.parametrize("specname", ["star7", "star25", "box27"])
def test_fused_local_apply_schedules_bitwise(specname, policy):
    """Blocking and overlap reach the kernel on the same padded block on one
    rank and agree bitwise, for every policy; both equal apply_ref and the
    plain halo path (``core.halo.local_apply``, the spmd backend's SpMV)."""
    spec = jst.get_spec(specname)
    cj = jst.random_nonsymmetric(jax.random.PRNGKey(4), (6, 5, 8), spec=spec)
    cf = carry_coeffs(cj)
    pol = tprec.get_policy(policy)
    v = torch.randn((6, 5, 8), generator=torch.Generator().manual_seed(5))
    fab = FabricAxes()
    ub = fused_local_apply(cf, v, fab, policy=pol, schedule=BLOCKING)
    uo = fused_local_apply(cf, v, fab, policy=pol, schedule=OVERLAP)
    assert_bitwise(ub, uo)
    cfs, vs = cf.astype(pol.storage), v.to(pol.storage)
    assert_bitwise(ub, tst.apply_ref(cfs, vs, policy=pol))
    for sched in (BLOCKING, OVERLAP):
        assert_bitwise(local_apply(cfs, vs, fab, policy=pol, schedule=sched), ub)


def test_multi_rank_fabric_raises():
    cf = tst.poisson((4, 4, 4), device="cpu")
    v = torch.ones((4, 4, 4))
    # a split axis exchanges halos, which needs a process group of the
    # fabric's size (tests/test_torch_dist_halo.py runs one)
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        fused_local_apply(cf, v, FabricAxes(nx=2), policy=tprec.F32, schedule=BLOCKING)
