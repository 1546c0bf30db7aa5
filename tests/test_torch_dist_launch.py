"""The CLI across ranks: ``torchrun --nproc-per-node 4 -m
repro_torch.launch.solve --device cpu`` on a 2x2 gloo fabric, its run
bundle, and its executed collective counts against the JAX package's
lowered counts for the same programs (``tests/test_obs.py::
test_emitted_collective_counts_match_hlo``).

* The run prints the rank-to-device map and the fabric ``{'data': 2,
  'model': 2}`` and converges; with ``--profile --run-dir`` rank 0 alone
  writes one bundle (its profiler trace included), whose ``collectives``
  event lists every rank's counts (8 permutes per iteration) and whose
  manifest names the world, the backend and the rank-to-device map.
* ``rank_system``: every rank's block of a seeded system (uniform, random
  and raw heterogeneous coefficients, one RHS and two) and ``b`` formed
  across the ranks equal the one-rank CLI's arrays on that block bit for
  bit; rank 0 alone draws the random ones.
* Per rank, a solve of n iterations runs ``setup + n x body`` AllReduces;
  ``setup + body`` equals the AllReduces of JAX's lowered four-device solve
  (``bicgstab``: 1 + 3, ``pipelined_bicgstab``: 1 + 1) under both schedules,
  and the permutes per iteration equal those of JAX's lowered
  ``make_iteration_fn`` (8); overlap sends as many as blocking.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_port import REPO, finish, run_with_ranks, start_with_devices  # noqa: E402

SOLVERS = ("bicgstab", "pipelined_bicgstab")
SCHEDULES = ("blocking", "overlap")

JAX = """
import json, jax, jax.numpy as jnp
from repro.core import bicgstab, precision, stencil
from repro.launch.mesh import make_mesh_for_devices
from repro.obs.metrics import count_collectives
mesh = make_mesh_for_devices(4)
cf = stencil.poisson((8, 8, 8))
b = jnp.ones((8, 8, 8), jnp.float32)
out = {}
for solver in %r:
    for schedule in %r:
        f = lambda c, v: bicgstab.solve_distributed(mesh, c, v, tol=0.0, maxiter=6,
                                                    policy=precision.F32, solver=solver,
                                                    schedule=schedule)
        out[f"{solver}/{schedule}"] = count_collectives(jax.jit(f).lower(cf, b).as_text())
it = bicgstab.make_iteration_fn(mesh, policy=precision.F32)
out["iteration"] = count_collectives(jax.jit(it).lower(cf, b, b, b, b, jnp.float32(1)).as_text())
print(json.dumps(out))
"""

PORT = """
import json
from repro_torch.launch import solve
from repro_torch.obs import metrics
out = {}
for solver in %r:
    for schedule in %r:
        per = []
        for k in (3, 6):
            res = solve.main(["--device", "cpu", "--mesh", "8", "8", "8", "--policy", "f32",
                              "--problem", "poisson", "--tol", "0", "--maxiter", str(k),
                              "--solver", solver, "--schedule", schedule])
            per.append(res["collectives"])
        out[f"{solver}/{schedule}"] = per
if RANK == 0:
    print(json.dumps(out))
"""


def _rank_blocks_check():
    """On each rank: its blocks of seeded systems and ``b`` against the
    one-rank CLI's arrays; rank 0 prints every case's verdict."""
    from repro_torch.core import dist, halo, precision, stencil
    from repro_torch.launch import solve
    from repro_torch.launch.mesh import make_mesh_for_devices

    fabric = halo.FabricAxes.from_mesh(make_mesh_for_devices(4))
    cpu, out = torch.device("cpu"), {}
    for sname, problem, nrhs in (("star7", None, 1), ("box27", None, 2),
                                 ("star7", "heterogeneous", 1), ("star25", None, 1),
                                 ("star7", "random", 2)):
        spec = stencil.get_spec(sname)
        name, cf, xt = solve.rank_system(problem, spec, (16, 16, 8), fabric, seed=3,
                                         device=cpu, nrhs=nrhs)
        b = halo.local_apply(cf, xt, fabric, policy=precision.F32)
        name1, cf1, b1 = solve.manufactured_system(problem, spec, (16, 16, 8), seed=3,
                                                   device=cpu, nrhs=nrhs)
        same = name == name1 and torch.equal(
            b, halo.local_block(b1, fabric, 1 if nrhs > 1 else 0)) and all(
            torch.equal(cf.diags[n], halo.local_block(cf1.diags[n], fabric))
            for n in spec.names)
        same = same and ((cf.diag is None and cf1.diag is None)
                         or torch.equal(cf.diag, halo.local_block(cf1.diag, fabric)))
        out[f"{sname}/{problem}/{nrhs}"] = all(dist.all_gather_object(bool(same)))
    if dist.rank() == 0:
        print(json.dumps(out))


def test_rank_blocks_are_the_one_rank_system(tmp_path):
    outs = run_with_ranks(_rank_blocks_check, 4, tmp_path)
    got = json.loads(outs[0].strip().splitlines()[-1])
    assert got and all(got.values()), got


def test_fabric_shape_and_rank_coordinates():
    from repro_torch.launch.mesh import RankMesh, fabric_shape, make_mesh_for_devices

    assert fabric_shape(make_mesh_for_devices(8, pods=2)) == (2, 2, 2)
    assert fabric_shape(make_mesh_for_devices(4)) == (1, 2, 2)
    mesh = RankMesh(("pod", "data", "model"), (2, 1, 2), rank=3)
    assert mesh.coords == {"pod": 1, "data": 0, "model": 1}
    from repro_torch.core.halo import FabricAxes

    fab = FabricAxes.from_mesh(mesh)
    assert fab.coords == (0, 1, 1) and fab.rank_at(fab.coords) == 3
    assert [fab.at_rank(r).coords for r in range(4)] == [(0, 0, 0), (0, 1, 0), (0, 0, 1),
                                                         (0, 1, 1)]
    assert fab.peers(1) == (2, None) and fab.peers(2) == (1, None) and fab.peers(0) == (
        None, None)


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_counts")
    jax_proc = start_with_devices(JAX % (SOLVERS, SCHEDULES), 4)
    outs = run_with_ranks(PORT % (SOLVERS, SCHEDULES), 4, tmp)
    return (json.loads(outs[0].strip().splitlines()[-1]),
            json.loads(finish(jax_proc).strip().splitlines()[-1]))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("solver", SOLVERS)
def test_executed_counts_match_the_lowered_program(counts, solver, schedule):
    port, jax_out = counts
    (a3, a6) = (c["allreduce_total"] for c in port[f"{solver}/{schedule}"])
    (p3, p6) = (c["ppermute_total"] for c in port[f"{solver}/{schedule}"])
    body, setup = (a6 - a3) // 3, a3 - 3 * ((a6 - a3) // 3)
    assert (a6 - a3) % 3 == 0 and setup + body == jax_out[f"{solver}/{schedule}"][
        "allreduce_total"], (port, jax_out)
    assert body == {"bicgstab": 3, "pipelined_bicgstab": 1}[solver]
    if solver == "bicgstab":
        assert p3 == 3 * jax_out["iteration"]["ppermute_total"] == 3 * 8
        assert body == jax_out["iteration"]["allreduce_total"]
    other = "overlap" if schedule == "blocking" else "blocking"
    assert port[f"{solver}/{schedule}"] == port[f"{solver}/{other}"]
    if solver == "bicgstab":
        assert p6 == 2 * p3          # no setup SpMV: every exchange is in the loop


@pytest.fixture(scope="module")
def torchrun(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("dist_bundle") / "bundle"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.solve", "--device", "cpu", "--mesh", "16", "16", "8",
         "--policy", "f32", "--backend", "fused", "--profile", "--run-dir", str(run_dir)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout, run_dir


def test_cli_converges_on_the_2x2_fabric(torchrun):
    out, _ = torchrun
    lines = out.splitlines()
    assert lines[0] == "ranks on gloo: 0:cpu 1:cpu 2:cpu 3:cpu", lines[0]
    assert "on fabric {'data': 2, 'model': 2}" in out
    assert "converged: True" in out
    true = float(next(ln for ln in lines if ln.startswith("true rel-residual")).split()[-1])
    assert true < 1e-5
    assert sum(ln.startswith("iterations:") for ln in lines) == 1      # rank 0 alone prints


def test_one_bundle_with_every_ranks_counts(torchrun):
    _, run_dir = torchrun
    assert sorted(os.listdir(run_dir)) == ["events.jsonl", "manifest.json", "torch_profile",
                                           "trace.json"]
    assert os.listdir(run_dir / "torch_profile")          # rank 0's profiler trace
    with open(run_dir / "manifest.json") as f:
        man = json.load(f)
    assert man["dist"] == {"world_size": 4, "backend": "gloo", "rank_devices": ["cpu"] * 4}
    with open(run_dir / "events.jsonl") as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    (coll,) = [e for e in events if e["event"] == "collectives"]
    (solve_ev,) = [e for e in events if e["event"] == "solve"]
    (n,) = solve_ev["iterations"]
    want = {"allreduce_total": 1 + 3 * n, "ppermute_total": 8 * n}
    assert {k: coll[k] for k in want} == want, coll
    assert coll["per_rank"] == [want] * 4
