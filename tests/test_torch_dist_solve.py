"""The multi-rank solve (``core/bicgstab.py``, ``core/operator.py``) on four
gloo ranks on the CPU, a 2x2 fabric, against the JAX package's solve on four
devices and against the port's own invariants.

* BiCGStab on the 16x16x8 convdiff (star7) for seeds 0-2, f32 at tol 1e-6,
  ``spmd`` and ``fused`` (plain versions here): iteration counts held to
  JAX's four-device spmd solve by ROADMAP §3's gap rule (every seed within
  8, the mean within 2), ``x`` within 1e-5 of max|x| of JAX's; at
  ``bf16_mixed`` (tol 1e-2) the same gap rule, and ``x`` no farther from
  JAX's than JAX's own ``x`` is from the manufactured solution, spmd
  against JAX's spmd and fused against JAX's ``pallas`` backend (blocks of
  8x8x8 in interpret mode), whose bf16 dots round their products as the
  port's fused ones do.
* The fused solve with its dots taken in the spmd order equals the spmd
  solve bit for bit.
* Executed counts per rank: 1 + 3n AllReduces (2 + 5n separate), 8n
  permutes, for B = 1 and B = 4 alike; the B = 1 batch equals the
  unbatched solve bit for bit; ``backend="reference"`` is refused.
* ``cg``, ``pipelined_bicgstab`` (one AllReduce per iteration) and
  Chebyshev converge on four ranks; Chebyshev's ``lmax`` is its one-rank
  value.
* ``make_iteration_fn`` on four ranks equals the first step of the
  four-rank fused loop bit for bit; ``solve_refined`` over the mesh
  refines to f32 accuracy.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import finish, run_with_ranks, start_with_devices  # noqa: E402

SHAPE = (16, 16, 8)
SEEDS = (0, 1, 2)
TOLS = {"f32": 1e-6, "bf16_mixed": 1e-2}
#: ROADMAP §3: summation order alone moves f32 counts by up to 6 at the
#: default cell; every seed within 8, the mean within 2
SEED_GAP, MEAN_GAP = 8, 2
#: f32: x within 1e-5 of max|x| of JAX's x
X_TOL_F32 = 1e-5

#: the JAX backend the port's fused path is held to, per policy
JAX_FUSED = {"f32": "spmd", "bf16_mixed": "pallas"}

SYSTEM = """
import numpy as np
SHAPE, SEEDS, TOLS, JAX_FUSED = %r, %r, %r, %r
def x_true(seed, b=0):
    rng = np.random.default_rng(100 + seed)
    return rng.standard_normal(((b,) if b else ()) + SHAPE).astype(np.float32)
"""

JAX = SYSTEM + """
import jax, jax.numpy as jnp
from repro.core import bicgstab, precision, stencil
from repro.launch.mesh import make_mesh_for_devices
mesh = make_mesh_for_devices(4)
cf = stencil.convection_diffusion(SHAPE)
out = {}
for pol_name, tol in TOLS.items():
    pol = precision.get_policy(pol_name)
    # the port's fused bf16 dots round their products as the pallas
    # kernels do (Policy.dot does not), so in bf16 it is held to pallas
    for port_backend, backend in (("spmd", "spmd"), ("fused", JAX_FUSED[pol_name])):
        solve = jax.jit(lambda c, b: bicgstab.solve_distributed(
            mesh, c, b, tol=tol, maxiter=400, policy=pol, backend=backend))
        for seed in SEEDS:
            b = stencil.rhs_for_solution(cf, jnp.asarray(x_true(seed)))
            res = solve(cf, b.astype(pol.storage))
            out[f"{pol_name}/{seed}/{port_backend}/x"] = np.asarray(res.x.astype(jnp.float32))
            out[f"{pol_name}/{seed}/{port_backend}/it"] = np.asarray(res.iterations)
np.savez(%r, **out)
print("OK")
"""

PORT = SYSTEM + """
import dataclasses, json, torch
from repro_torch.core import bicgstab, halo, precision, stencil
from repro_torch.core.operator import FusedOps, make_operator
from repro_torch.core.precond import PrecondConfig, build_precond
from repro_torch.core.solvers import get_solver
from repro_torch.launch.mesh import RankMesh, make_mesh_for_devices
from repro_torch.obs import metrics

mesh = make_mesh_for_devices(4)
fabric = halo.FabricAxes.from_mesh(mesh)
cf = stencil.convection_diffusion(SHAPE, device="cpu")
out, info = {}, {}

def counted(fn):
    metrics.reset()
    res = fn()
    return res, [metrics.counter("comm.allreduce").value, metrics.counter("comm.ppermute").value]

def with_spmd_dots(op):
    d, f = op.policy.dot, op.fused
    def update_q_dots(alpha, r, s, y):
        q = f.update_q_dots(alpha, r, s, y)[0]
        return q, d(q, y), d(y, y)
    def update_xr_dots(alpha, omega, x, p, q, y, r0):
        x, r = f.update_xr_dots(alpha, omega, x, p, q, y, r0)[:2]
        return x, r, d(r0, r), d(r, r)
    return dataclasses.replace(op, fused=FusedOps(
        dot_partial=d, update_q_dots=update_q_dots, update_xr_dots=update_xr_dots,
        update_p=f.update_p))

def rhs(seed, b=0):
    return stencil.rhs_for_solution(cf, torch.from_numpy(x_true(seed, b)))

for pol_name, tol in TOLS.items():
    pol = precision.get_policy(pol_name)
    for seed in SEEDS:
        b = rhs(seed).to(pol.storage)
        for backend in ("spmd", "fused"):
            res, c = counted(lambda: bicgstab.solve_distributed(
                mesh, cf, b, tol=tol, maxiter=400, policy=pol, backend=backend))
            key = f"{pol_name}/{seed}/{backend}"
            out[key + "/x"] = res.x.float().numpy()
            info[key] = dict(it=int(res.iterations), conv=bool(res.converged), counts=c)
        if pol_name == "f32":
            # the kernels with spmd-order dots, on this rank's block
            op = with_spmd_dots(make_operator("fused", cf.astype(pol.storage).__class__(
                {n: halo.local_block(a, fabric) for n, a in cf.diags.items()}), fabric,
                policy=pol))
            r2 = get_solver("bicgstab")(op, halo.local_block(b, fabric), None, tol=tol,
                                        maxiter=400, policy=pol)
            spmd = halo.local_block(torch.from_numpy(out[f"{pol_name}/{seed}/spmd/x"]), fabric)
            same = torch.equal(r2.x, spmd) and int(r2.iterations) == info[
                f"{pol_name}/{seed}/spmd"]["it"]
            info[f"dots/{seed}"] = all(dist.all_gather_object(bool(same)))
            _, c = counted(lambda: bicgstab.solve_distributed(
                mesh, cf, b, tol=tol, maxiter=400, policy=pol, backend="fused",
                fused_reductions=False))
            info[f"separate/{seed}"] = c

# batches: B = 1 against the unbatched solve, B = 4 counts
pol = precision.F32
b1, b4 = rhs(0).unsqueeze(0), rhs(0, 4)
for backend in ("spmd", "fused"):
    r1, c1 = counted(lambda: bicgstab.solve_distributed(mesh, cf, b1, tol=1e-6, maxiter=400,
                                                        policy=pol, backend=backend))
    r0, _ = counted(lambda: bicgstab.solve_distributed(mesh, cf, b1[0], tol=1e-6, maxiter=400,
                                                       policy=pol, backend=backend))
    r4, c4 = counted(lambda: bicgstab.solve_distributed(mesh, cf, b4, tol=1e-6, maxiter=400,
                                                        policy=pol, backend=backend))
    info[f"batch/{backend}"] = dict(
        b1_equal=bool(torch.equal(r1.x[0], r0.x)) and r1.iterations.tolist() == [
            int(r0.iterations)],
        b1=dict(it=r1.iterations.tolist(), counts=c1),
        b4=dict(it=r4.iterations.tolist(), counts=c4, conv=r4.converged.tolist()))
try:
    bicgstab.solve_distributed(mesh, cf, rhs(0), backend="reference")
    info["reference"] = "no error"
except ValueError as e:
    info["reference"] = str(e)

# the rest of the solver stack
poisson = stencil.poisson(SHAPE, device="cpu")
bp = stencil.rhs_for_solution(poisson, torch.from_numpy(x_true(0)))
for label, solver, system, rhs_, precond, tol in (
        ("cg", "cg", poisson, bp, "none", 1e-5),
        ("pipelined_bicgstab", "pipelined_bicgstab", cf, rhs(0), "none", 1e-6),
        ("chebyshev", "bicgstab", poisson, bp, "chebyshev", 1e-6)):
    res, c = counted(lambda: bicgstab.solve_distributed(
        mesh, system, rhs_, tol=tol, maxiter=400, policy=pol, backend="fused", solver=solver,
        precond=precond))
    short = [counted(lambda: bicgstab.solve_distributed(
        mesh, system, rhs_, tol=0.0, maxiter=k, policy=pol, backend="fused", solver=solver,
        precond=precond))[1][0] for k in (3, 6)]
    info[label] = dict(it=int(res.iterations), conv=bool(res.converged), counts=c,
                       allreduce_per_iter=(short[1] - short[0]) / 3)
op4 = make_operator("spmd", halo.local_coeffs(poisson, fabric), fabric, policy=pol)
lmax4 = build_precond(PrecondConfig(name="chebyshev"), op4).lmax
lmax1 = build_precond(PrecondConfig(name="chebyshev"), make_operator(
    "spmd", poisson, halo.FabricAxes(), policy=pol)).lmax
info["lmax_equal"] = bool(torch.equal(lmax4, lmax1))

# iterative refinement over the mesh (spmd inner solves, global_apply residuals)
_, rels = bicgstab.solve_refined(cf, rhs(2), mesh=mesh, outer_iters=3, inner_tol=1e-3,
                                 inner_policy=precision.MIXED)
info["refined"] = rels.tolist()

# make_iteration_fn against the first step of the fused loop
b = rhs(1)
x0 = torch.zeros_like(b)
rho = (b.double() ** 2).sum().float()
first = bicgstab.solve_distributed(mesh, cf, b, tol=0.0, maxiter=1, policy=pol, backend="fused")
bb = bicgstab.make_operator("fused", halo.local_coeffs(cf, fabric), fabric, policy=pol)
rho = bb.reduce_partials([bb.fused.dot_partial(halo.local_block(b, fabric),
                                               halo.local_block(b, fabric))])[0]
x, r, p, rho1, res2 = bicgstab.make_iteration_fn(mesh, policy=pol, backend="fused")(
    cf, x0, b, b, b, rho)
info["iteration_fn"] = bool(torch.equal(x, first.x)) and bool(
    torch.equal(torch.sqrt(res2 / rho), first.rel_residual))
if RANK == 0:
    np.savez(%r, **out)
    print(json.dumps(info))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_solve")
    jax_npz, port_npz = str(tmp / "jax.npz"), str(tmp / "port.npz")
    args = (SHAPE, SEEDS, TOLS, JAX_FUSED)
    jax_proc = start_with_devices(JAX % (*args, jax_npz), 4)
    outs = run_with_ranks(PORT % (*args, port_npz), 4, tmp)
    finish(jax_proc)
    return dict(np.load(port_npz)), dict(np.load(jax_npz)), json.loads(
        outs[0].strip().splitlines()[-1])


@pytest.mark.parametrize("backend", ["spmd", "fused"])
@pytest.mark.parametrize("pol", list(TOLS))
def test_iterations_and_x_held_to_jax(runs, pol, backend):
    port, jax_out, info = runs
    gaps = [info[f"{pol}/{s}/{backend}"]["it"] - int(jax_out[f"{pol}/{s}/{backend}/it"])
            for s in SEEDS]
    assert max(map(abs, gaps)) <= SEED_GAP and abs(sum(gaps) / len(gaps)) <= MEAN_GAP, gaps
    ns = {}
    exec(SYSTEM % (SHAPE, SEEDS, TOLS, JAX_FUSED), ns)
    for s in SEEDS:
        assert info[f"{pol}/{s}/{backend}"]["conv"], (pol, s, backend)
        x, want = port[f"{pol}/{s}/{backend}/x"], jax_out[f"{pol}/{s}/{backend}/x"]
        if pol == "f32":
            tol = X_TOL_F32 * np.abs(want).max()
        else:   # 16-bit: no farther from JAX's x than JAX's x is from the solution
            tol = np.abs(want - ns["x_true"](s)).max()
        assert np.abs(x - want).max() <= tol, (pol, s, np.abs(x - want).max(), tol)


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_with_spmd_dots_is_the_spmd_solve(runs, seed):
    assert runs[2][f"dots/{seed}"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("backend", ["spmd", "fused"])
def test_collective_counts_per_rank(runs, seed, backend):
    """1 + 3n AllReduces and 8n permutes on a 2x2 fabric (x0 = None: no
    setup SpMV), 2 + 5n with one AllReduce per dot."""
    info = runs[2]
    for pol in TOLS:
        run = info[f"{pol}/{seed}/{backend}"]
        n = run["it"]
        assert run["counts"] == [1 + 3 * n, 8 * n], run
    if backend == "fused":
        n = info[f"f32/{seed}/fused"]["it"]
        assert info[f"separate/{seed}"] == [2 + 5 * n, 8 * n]


@pytest.mark.parametrize("backend", ["spmd", "fused"])
def test_batches(runs, backend):
    """B = 1 is the unbatched solve bit for bit; B = 1 and B = 4 count the
    same collectives per iteration run (the loop runs max(its) times)."""
    rec = runs[2][f"batch/{backend}"]
    assert rec["b1_equal"]
    for b in ("b1", "b4"):
        n = max(rec[b]["it"])
        assert rec[b]["counts"] == [1 + 3 * n, 8 * n], rec
    assert all(rec["b4"]["conv"])


def test_reference_backend_refused(runs):
    assert "single-address-space" in runs[2]["reference"]


@pytest.mark.parametrize("label", ["cg", "pipelined_bicgstab", "chebyshev"])
def test_solver_stack_converges(runs, label):
    rec = runs[2][label]
    assert rec["conv"], rec
    if label == "pipelined_bicgstab":
        assert rec["allreduce_per_iter"] == 1.0, rec


def test_chebyshev_bounds_are_the_one_rank_bounds(runs):
    assert runs[2]["lmax_equal"]


def test_refinement_over_the_mesh(runs):
    """bf16 inner solves on four ranks, f32 residuals from ``global_apply``:
    the true residual falls at every outer step, below 1e-5 at the end."""
    rels = runs[2]["refined"]
    assert all(b < a for a, b in zip(rels, rels[1:])) and rels[-1] < 1e-5, rels


def test_iteration_fn_is_the_first_fused_step(runs):
    assert runs[2]["iteration_fn"]
