"""Iterative refinement across ranks (``core/bicgstab.py:refine_block`` and
``python -m repro_torch.launch.solve --refine`` under ranks) on four gloo
ranks on the CPU, a 2x2 fabric, 16x16x8 convdiff with ``bf16_mixed`` inner
solves.

* ``refine_block`` on each rank's block, gathered, equals the port's
  ``solve_refined(mesh=...)`` on global arrays over the same ranks bit for
  bit (it takes each rank's block and runs ``refine_block``), and ``rels``
  are held within ``RELS_ULP`` f32 ulps.
* The CLI's ``--refine`` under ranks prints that solve's trajectory (the
  same ulps) and its max error bit for bit, and executes ``2 + 3 n_k``
  AllReduces per rank in outer step ``k`` plus 2 (``||b||`` and the last
  residual), with ``n_k`` the inner solve's iterations.
* Against the one-rank refine (the inner solves' dots sum in another
  order) and JAX's four-device ``solve_refined(mesh=...)`` (with
  ``--xla_allow_excess_precision=false``: its bf16 roundings as the port's;
  its f32 sums contract into FMAs, ROADMAP §3), ``x`` is held within
  ``X_TOL`` of max|x_true| and ``rels`` within ``RELS_RTOL`` (an inner solve
  stops at tol 1e-3 on an iteration count that the dot order moves, as in
  ``tests/test_torch_refine.py``).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import finish, run_with_ranks, start_with_devices  # noqa: E402

SHAPE = (16, 16, 8)
OUTER = 4
#: rels of the per-rank form against the global-array form: the same
#: residuals, norms summed in another order
RELS_ULP = 4
#: x against the one-rank and JAX refines, as a share of max|x_true|; rels
#: relative (rtol) above an absolute floor (atol)
X_TOL = 1e-5
RELS_RTOL, RELS_ATOL = 0.5, 1e-6

SYSTEM = """
import numpy as np
SHAPE, OUTER = %r, %r
X_TRUE = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
""" % (SHAPE, OUTER)

JAX = SYSTEM + """
import jax, jax.numpy as jnp
from repro.core import bicgstab, precision, stencil
from repro.launch.mesh import make_mesh_for_devices
cf = stencil.convection_diffusion(SHAPE)
b = stencil.rhs_for_solution(cf, jnp.asarray(X_TRUE))
mesh = make_mesh_for_devices(4)
x, rels = jax.jit(lambda c, v: bicgstab.solve_refined(
    c, v, mesh=mesh, outer_iters=OUTER, inner_policy=precision.MIXED))(cf, b)
np.savez(%r, x=np.asarray(x), rels=np.asarray(rels))
print("OK")
"""

PORT = SYSTEM + """
import json, torch
from repro_torch.core import bicgstab, halo, precision, stencil
from repro_torch.launch import solve as cli
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.obs import metrics

mesh = make_mesh_for_devices(4)
fabric = halo.FabricAxes.from_mesh(mesh)
cf = stencil.convection_diffusion(SHAPE, device="cpu")
b = stencil.rhs_for_solution(cf, torch.from_numpy(X_TRUE))
kw = dict(outer_iters=OUTER, inner_policy=precision.MIXED)
xg, rels_g = bicgstab.solve_refined(cf, b, mesh=mesh, **kw)
metrics.reset()
xb, rels_b, inner = bicgstab.refine_block(mesh, halo.local_coeffs(cf, fabric),
                                          halo.local_block(b, fabric), **kw)
allreduce = metrics.counter("comm.allreduce").value
xb = halo.gather_blocks(xb, fabric)
info = dict(x_equal=bool(torch.equal(xb, xg)), rels_block=rels_b.tolist(),
            rels_global=rels_g.tolist(), inner=inner, allreduce=allreduce)
info["all_x_equal"] = all(dist.all_gather_object(info["x_equal"]))
# the CLI on the same system (convdiff and x_true of seed 0; --mesh 16 16 8)
x_true = cli.manufactured_solution(SHAPE, seed=0, device=torch.device("cpu"))
bc = stencil.rhs_for_solution(cf, x_true)
xc, rels_c = bicgstab.solve_refined(cf, bc, mesh=mesh, **kw)
res = cli.main(["--device", "cpu", "--mesh", *map(str, SHAPE), "--refine",
                "--policy", "bf16_mixed"])
info["cli"] = {k: res[k] for k in ("refine_rel_residuals", "max_err", "inner_iterations",
                                   "collectives", "per_rank")}
info["cli_global"] = dict(rels=rels_c.tolist(), max_err=float((xc - x_true).abs().max()))
if RANK == 0:
    one_x, one_rels = bicgstab.solve_refined(cf, b, **kw)
    np.savez(%r, x=xb.numpy(), one_x=one_x.numpy(), one_rels=one_rels.numpy())
    print(json.dumps(info))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_refine")
    jax = start_with_devices(JAX % str(tmp / "jax.npz"), 4, strict_bf16=True)
    outs = run_with_ranks(PORT % str(tmp / "port.npz"), 4, tmp)
    finish(jax)
    return (json.loads(outs[0].strip().splitlines()[-1]), np.load(tmp / "port.npz"),
            np.load(tmp / "jax.npz"))


def _ulps(a, b) -> np.ndarray:
    a, b = np.float32(a), np.float32(b)
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) / np.spacing(
        np.maximum(np.abs(a), np.abs(b)))


def test_refine_block_equals_the_global_array_refine(runs):
    info, _, _ = runs
    assert info["x_equal"] and info["all_x_equal"]
    assert len(info["rels_block"]) == OUTER + 1
    assert (_ulps(info["rels_block"], info["rels_global"]) <= RELS_ULP).all(), (
        info["rels_block"], info["rels_global"])
    assert info["rels_block"][-1] < 1e-5


def test_allreduces_per_outer_step(runs):
    info, _, _ = runs
    assert len(info["inner"]) == OUTER and all(n > 0 for n in info["inner"])
    assert info["allreduce"] == 2 + sum(2 + 3 * n for n in info["inner"])


def test_cli_refine_under_ranks(runs):
    """The CLI's trajectory and max error are the global-array refine's on
    the same system, and every rank ran the same collectives."""
    info, _, _ = runs
    cli, want = info["cli"], info["cli_global"]
    assert cli["max_err"] == want["max_err"]
    assert (_ulps(cli["refine_rel_residuals"], want["rels"]) <= RELS_ULP).all()
    n = cli["inner_iterations"]
    # the error's max is one more AllReduce, after the counts were read
    assert cli["collectives"]["allreduce_total"] == 2 + sum(2 + 3 * k for k in n)
    assert cli["per_rank"] == [cli["collectives"]] * 4
    assert cli["collectives"]["ppermute_total"] > 0


def test_refine_against_one_rank_and_jax(runs):
    info, port, jax = runs
    scale = X_TOL * np.abs(np.random.default_rng(3).standard_normal(SHAPE)).max()
    rels = np.asarray(info["rels_block"])
    assert np.abs(port["x"] - port["one_x"]).max() <= scale
    np.testing.assert_allclose(rels, port["one_rels"], rtol=RELS_RTOL, atol=RELS_ATOL)
    assert np.abs(port["x"] - jax["x"]).max() <= scale
    np.testing.assert_allclose(rels, jax["rels"], rtol=RELS_RTOL, atol=RELS_ATOL)
