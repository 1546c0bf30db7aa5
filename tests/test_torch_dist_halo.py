"""The depth-r halo exchange across gloo ranks (``core/dist.py``,
``core/halo.py``, ``core/comm.py``): ``global_apply`` on four CPU ranks.

On the fabrics 2x2, 1x4, 4x1 and (pod 2, data 1, model 2), for star7,
box27 and star25, f32 and bf16, one RHS and two:

* the four-rank ``global_apply`` equals the port's one-rank apply of the
  whole array bit for bit, under both schedules, and the kernel backend's
  overlapped SpMV (its plain versions here) equals it in the split ring form
  and with ``fuse_ring``;
* it is held to the JAX package's ``global_apply`` on four devices: in f32
  to 2 ulp of each element's largest term (XLA on the CPU contracts FMAs),
  in bf16 bit for bit against JAX's strict mode
  (``--xla_allow_excess_precision=false``);
* every exchange counts 2 permutes per split axis on every rank, whatever B;
* a halo deeper than the block raises, as in the JAX package.

One spawn of four ranks and one JAX subprocess, run side by side, feed
every case.
"""

import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import (  # noqa: E402
    assert_bitwise, assert_ulp_close, finish, run_with_ranks, start_with_devices,
)
from repro_torch.core import halo as thalo  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import stencil as tst  # noqa: E402
from repro_torch.launch.mesh import RankMesh  # noqa: E402

SHAPE = (16, 16, 8)      # every split block is >= 4 (star25's radius) thick
FABRICS = {"2x2": (1, 2, 2), "1x4": (1, 1, 4), "4x1": (1, 4, 1), "pods2x1x2": (2, 1, 2)}
SPECS = ("star7", "box27", "star25")
POLICIES = ("f32", "bf16_mixed")
BATCHES = (0, 2)          # 0: one unbatched RHS; 2: a batch of two
CASES = list(itertools.product(FABRICS, SPECS, POLICIES, BATCHES))
ONE_RANK = RankMesh(("data", "model"), (1, 1))

#: the inputs, made with numpy from a seed in every process
INPUTS = """
import numpy as np
def inputs(spec, b):
    rng = np.random.default_rng(11 + len(spec.names))
    cf = {n: ((rng.random(SHAPE) - 0.5) * 2.0 / spec.n_offsets).astype(np.float32)
          for n in spec.names}
    v = rng.standard_normal(((b,) if b else ()) + SHAPE).astype(np.float32)
    return cf, v
"""

PORT = INPUTS + """
import json, torch, numpy as np
from repro_torch.core import halo, precision, stencil
from repro_torch.core.comm import OVERLAP
import dataclasses
from repro_torch.core.tuning import default_config
from repro_torch.kernels.stencil_nd.ops import fused_local_apply
from repro_torch.launch.mesh import RankMesh
from repro_torch.obs import metrics
SHAPE, FABRICS, CASES = %r, %r, %r
out, counts = {}, {}
for fab, spec_name, pol_name, nb in CASES:
    pods, nx, ny = FABRICS[fab]
    mesh = (RankMesh(("pod", "data", "model"), (pods, nx, ny), RANK) if pods > 1
            else RankMesh(("data", "model"), (nx, ny), RANK))
    spec, pol = stencil.get_spec(spec_name), precision.get_policy(pol_name)
    cfn, vn = inputs(spec, nb)
    cf = stencil.StencilCoeffs({n: torch.from_numpy(a) for n, a in cfn.items()})
    v = torch.from_numpy(vn)
    key = f"{fab}/{spec_name}/{pol_name}/{nb}"
    nb = 1 if nb else 0      # B = 2 rides one leading batch axis
    metrics.reset()
    u = halo.global_apply(mesh, cf, v, policy=pol, schedule="blocking")
    counts[key] = metrics.counter("comm.ppermute").value
    same = torch.equal(halo.global_apply(mesh, cf, v, policy=pol, schedule="overlap"), u)
    # the kernel backend's overlapped SpMV on this rank's block: split ring
    # form and fused ring form (plain versions on CPU tensors)
    fabric = halo.FabricAxes.from_mesh(mesh)
    cfl = halo.local_coeffs(cf, fabric).astype(pol.storage)
    vl = halo.local_block(v, fabric, nb).to(pol.storage)
    split = fused_local_apply(cfl, vl, fabric, policy=pol, schedule=OVERLAP)
    ring = dataclasses.replace(default_config(spec, pol.storage, tuple(cfl.shape),
                                              2 if nb else 1), fuse_ring=True)
    fused = fused_local_apply(cfl, vl, fabric, policy=pol, schedule=OVERLAP, config=ring)
    mine = halo.local_block(u, fabric, nb)
    same_kernel = [bool(torch.equal(split, mine)), bool(torch.equal(fused, mine))]
    flags = torch.tensor([same, *same_kernel], dtype=torch.int32)
    flags = torch.stack(dist.all_gather(flags))
    if RANK == 0:
        out[key] = u.float().numpy()
        out[key + "/flags"] = flags.numpy()
try:
    halo.global_apply(RankMesh(("data", "model"), (1, 4), RANK), stencil.StencilCoeffs(
        {n: torch.zeros((8, 8, 6)) for n in stencil.STAR25.names}), torch.ones((8, 8, 6)))
    deep = "no error"
except ValueError as e:
    deep = str(e)
if RANK == 0:
    np.savez(%r, **out)
    print(json.dumps({"counts": counts, "deep": deep}))
"""

JAX = INPUTS + """
import json, jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.core import precision, stencil
from repro.core.halo import global_apply
SHAPE, FABRICS, CASES = %r, %r, %r
out = {}
for fab, spec_name, pol_name, nb in CASES:
    pods, nx, ny = FABRICS[fab]
    mesh = (make_mesh((pods, nx, ny), ("pod", "data", "model")) if pods > 1
            else make_mesh((nx, ny), ("data", "model")))
    spec, pol = stencil.get_spec(spec_name), precision.get_policy(pol_name)
    cfn, vn = inputs(spec, nb)
    cf = stencil.StencilCoeffs({n: jnp.asarray(a) for n, a in cfn.items()})
    apply = jax.jit(lambda c, v: global_apply(mesh, c, v, policy=pol, schedule="blocking"))
    u = apply(cf, jnp.asarray(vn))
    out[f"{fab}/{spec_name}/{pol_name}/{nb}"] = np.asarray(u.astype(jnp.float32))
np.savez(%r, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_halo")
    jax_npz, port_npz = str(tmp / "jax.npz"), str(tmp / "port.npz")
    args = (SHAPE, FABRICS, CASES)
    jax_proc = start_with_devices(JAX % (*args, jax_npz), 4, strict_bf16=True)
    outs = run_with_ranks(PORT % (*args, port_npz), 4, tmp)
    finish(jax_proc)
    info = json.loads(outs[0].strip().splitlines()[-1])
    return dict(np.load(port_npz)), dict(np.load(jax_npz)), info


def _one_rank(spec_name, pol_name, nb):
    """The port's one-rank apply of the whole array, and each element's
    largest term |v| + sum |c_i v_i| (f64) for the f32 tolerance."""
    ns = {"SHAPE": SHAPE}
    exec(INPUTS, ns)
    spec, pol = tst.get_spec(spec_name), tprec.get_policy(pol_name)
    cfn, vn = ns["inputs"](spec, nb)
    cf = tst.StencilCoeffs({n: torch.from_numpy(a) for n, a in cfn.items()})
    u = thalo.global_apply(ONE_RANK, cf, torch.from_numpy(vn), policy=pol)
    acf = tst.StencilCoeffs({n: torch.from_numpy(np.abs(a)).double() for n, a in cfn.items()})
    scale = tst.apply_ref(acf, torch.from_numpy(np.abs(vn)).double(), policy=tprec.F64)
    return u, scale


@pytest.mark.parametrize("fab,spec,pol,nb", CASES, ids=lambda c: str(c))
def test_global_apply_equals_one_rank_apply(runs, fab, spec, pol, nb):
    port, _, _ = runs
    key = f"{fab}/{spec}/{pol}/{nb}"
    u1, _ = _one_rank(spec, pol, nb)
    assert_bitwise(port[key], u1.float())


@pytest.mark.parametrize("fab,spec,pol,nb", CASES, ids=lambda c: str(c))
def test_schedules_and_ring_forms_agree_bitwise(runs, fab, spec, pol, nb):
    """Per rank: overlap = blocking, and the kernel backend's split and
    fused ring forms = the blocking apply's block."""
    port, _, _ = runs
    assert port[f"{fab}/{spec}/{pol}/{nb}/flags"].all()


@pytest.mark.parametrize("fab,spec,pol,nb", CASES, ids=lambda c: str(c))
def test_global_apply_held_to_jax(runs, fab, spec, pol, nb):
    port, jax_out, _ = runs
    key = f"{fab}/{spec}/{pol}/{nb}"
    if pol == "f32":
        _, scale = _one_rank(spec, pol, nb)
        assert_ulp_close(port[key], jax_out[key], scale.numpy(), n_ulp=2)
    else:
        assert_bitwise(port[key], jax_out[key])


def test_permutes_per_exchange(runs):
    """2 permutes per split axis per exchange, each schedule's SpMV one
    exchange, whatever B: blocking only is counted (one SpMV)."""
    _, _, info = runs
    split = {"2x2": 2, "1x4": 1, "4x1": 1, "pods2x1x2": 2}
    for fab, spec, pol, nb in CASES:
        assert info["counts"][f"{fab}/{spec}/{pol}/{nb}"] == 2 * split[fab]


def test_halo_deeper_than_block_raises(runs):
    _, _, info = runs
    assert "halo depth 4 exceeds the local block extent 2" in info["deep"], info["deep"]
