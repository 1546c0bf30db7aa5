"""Stencil-solver CLI: the paper's experiment on one GPU, or on the ranks of
a ``torchrun`` group.

    PYTHONPATH=src python -m repro_torch.launch.solve --backend fused
    PYTHONPATH=src python -m repro_torch.launch.solve --backend fused \
        --mesh 608 608 1536 --policy bf16_mixed --tol 0 --maxiter 30
    PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --mesh 8 8 8 --policy f32
    PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --mesh 8 8 8 --nrhs 2
    PYTHONPATH=src python -m repro_torch.launch.solve --solver cg --backend fused
    PYTHONPATH=src python -m repro_torch.launch.solve --precond chebyshev --problem poisson
    PYTHONPATH=src python -m repro_torch.launch.solve --refine
    PYTHONPATH=src python -m repro_torch.launch.solve --backend fused --obs --run-dir /tmp/run
    PYTHONPATH=src python -m repro_torch.launch.solve --backend fused --profile --maxiter 5
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.solve \
        --device cpu --mesh 16 16 8 --policy f32
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.solve \
        --backend fused --dist-backend gloo       # 4 ranks sharing one card
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.solve \
        --device cpu --mesh 16 16 8 --refine      # refinement, every rank on its block

Counterpart of ``python -m repro.launch.solve``, with its flag names and
defaults: builds a diagonally dominant system of the requested stencil shape,
solves it with the chosen Krylov solver through the chosen backend (``fused``
runs the CUDA kernels), optionally right-preconditioned, and reports
iterations, the recurrence and true residuals, the time per iteration on the
device it ran on, the collectives the solve ran, and the achieved share of
the card's f32 peak.  ``--nrhs B`` solves B right-hand sides as one block
solve and reports each RHS's numbers; ``--refine`` runs 16-bit inner solves
under f32 iterative refinement instead.  ``--obs`` records spans and metrics into a run bundle
(``results/runs/<run_id>/`` or ``--run-dir``), and ``--profile`` adds a
``torch.profiler`` trace in ``<run_dir>/torch_profile``.  It runs on the card
unless ``--device cpu`` is given, and refuses to start without one.

Under ``torchrun`` every rank runs the solve on its ``(bx, by, Z)`` block of
a near-square rank fabric (``launch/mesh.py``), exchanging halos with its
neighbours and summing dot partials by AllReduce (``--dist-backend``:
``nccl``, one rank per card, the default on the card; ``gloo``, the default
on the CPU, lets ranks share a card).  Uniform problems are built block by
block; a random system and the manufactured solution are drawn once, on
rank 0, which hands each rank its block.  ``b``, the true residual and the
collective counts are computed across the ranks; rank 0 alone prints and
writes the run bundle, which lists every rank's counts.  ``--refine`` runs
``bicgstab.refine_block`` on every rank's block, and its max error against
``x_true`` is the largest of the ranks'.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import math
import time

import torch

from repro_torch.core import bicgstab, dist, perfmodel, precision, stencil
from repro_torch.core.comm import SCHEDULES
from repro_torch.core.halo import FabricAxes, block_slices, local_apply
from repro_torch.core.operator import BACKENDS
from repro_torch.core.precond import PRECONDS, PrecondConfig
from repro_torch.core.solvers import SOLVERS
from repro_torch.core.solvers.common import emit_solve_metrics
from repro_torch.device import device_name, resolve_device, synchronize
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.obs import manifest as obs_manifest
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

PROBLEMS = ["convdiff", "random", "poisson", "heterogeneous", "seismic"]


def default_problem(problem: str | None, spec: stencil.StencilSpec,
                    solver: str = "bicgstab") -> str:
    """The problem asked for, or the shape-appropriate default."""
    if problem is not None:
        return problem
    if solver in ("cg", "pipelined_cg"):
        return "poisson"                     # CG wants a symmetric operator
    if spec == stencil.STAR7:
        return "convdiff"
    return "seismic" if spec.pattern == "star" else "random"


def build_problem(problem: str | None, spec: stencil.StencilSpec, shape, *,
                  generator: torch.Generator, device: torch.device,
                  solver: str = "bicgstab"):
    """(problem name, coefficients) for the requested pair, in f32 on
    ``device``.  The random problems draw from ``generator`` on its own
    device and are moved; the others are built on ``device``."""
    problem = default_problem(problem, spec, solver)
    if problem == "random":
        return problem, stencil.random_nonsymmetric(generator, shape, spec=spec).to(device)
    if problem == "poisson":
        return problem, stencil.poisson(shape, spec=spec, device=device)
    if problem == "heterogeneous":
        return problem, stencil.heterogeneous_poisson(generator, shape, spec=spec).to(device)
    if problem == "seismic":
        if spec.pattern != "star":
            raise SystemExit("--problem seismic needs a star stencil")
        return problem, stencil.high_order_star(shape, spec.radius, device=device)
    if problem == "convdiff":
        if spec != stencil.STAR7:
            raise SystemExit("--problem convdiff is the 7-point MFIX class; "
                             "use seismic/random/poisson for other stencils")
        return problem, stencil.convection_diffusion(shape, device=device)
    raise SystemExit(f"unknown problem {problem!r}")


def manufactured_solution(shape, *, seed: int, device: torch.device,
                          nrhs: int = 1) -> torch.Tensor:
    """The f32 solution ``x_true`` seeded by ``seed + 1``, drawn on the host
    and moved: ``(nrhs,) + shape`` for ``nrhs > 1``, else ``shape``."""
    xshape = (nrhs,) + tuple(shape) if nrhs > 1 else tuple(shape)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    return torch.randn(xshape, generator=gen).to(device)


def manufactured_problem(problem: str | None, spec: stencil.StencilSpec, shape, *,
                         seed: int, device: torch.device, solver: str = "bicgstab"):
    """(problem name, f32 coefficients on ``device``) seeded by ``seed``; a
    random problem is drawn on the host, so a seed names one system on
    every device."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return build_problem(problem, spec, shape, generator=gen, device=device, solver=solver)


def manufactured_system(problem: str | None, spec: stencil.StencilSpec, shape, *,
                        seed: int, device: torch.device, nrhs: int = 1,
                        solver: str = "bicgstab"):
    """(problem name, f32 coefficients, f32 right-hand side ``b = A x_true``)
    on ``device``: the system is seeded by ``seed``, the solution by ``seed +
    1``, both drawn on the host.  ``nrhs > 1`` gives a batch ``(nrhs,) +
    shape`` of solutions; ``nrhs == 1`` stays unbatched."""
    problem, cf = manufactured_problem(problem, spec, shape, seed=seed, device=device,
                                       solver=solver)
    x_true = manufactured_solution(shape, seed=seed, device=device, nrhs=nrhs)
    return problem, cf, stencil.rhs_for_solution(cf, x_true)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.solve")
    ap.add_argument("--mesh", type=int, nargs=3, default=[48, 48, 32],
                    metavar=("X", "Y", "Z"))
    ap.add_argument("--stencil", default="star7", choices=sorted(stencil.SPECS),
                    help="stencil shape: star7 (paper), star13, star25 (seismic RTM), box27")
    ap.add_argument("--solver", default="bicgstab", choices=sorted(SOLVERS),
                    help="Krylov solver (bicgstab: the paper's; cg: symmetric; "
                         "pipelined_*: one sync point per iteration)")
    ap.add_argument("--backend", default="spmd", choices=sorted(BACKENDS),
                    help="SpMV backend: spmd (halo apply, plain tensor ops), fused "
                         "(CUDA kernels + 3 sync points/iter), reference")
    ap.add_argument("--schedule", default="overlap", choices=sorted(SCHEDULES),
                    help="halo schedule (bit-identical results)")
    ap.add_argument("--precond", default="none", choices=sorted(PRECONDS),
                    help="right preconditioner (local: the sync points are unchanged)")
    ap.add_argument("--cheb-degree", type=int, default=3,
                    help="Chebyshev polynomial degree (degree - 1 extra SpMVs per apply)")
    ap.add_argument("--policy", default="bf16_mixed", choices=sorted(precision.POLICIES))
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=200)
    ap.add_argument("--problem", default=None, choices=PROBLEMS,
                    help="default: convdiff for star7, seismic for deeper stars, "
                         "random for box, poisson for --solver cg/pipelined_cg; "
                         "heterogeneous is the raw variable-diagonal case where "
                         "--precond jacobi does work")
    ap.add_argument("--nrhs", type=int, default=1,
                    help="right-hand sides solved as one block (batched) Krylov solve; "
                         "every sync point reduces the stacked [k, B] partials")
    ap.add_argument("--refine", action="store_true",
                    help="iterative refinement to f32 accuracy (16-bit inner "
                         "bicgstab/spmd solves in --policy)")
    ap.add_argument("--paper-separate-reductions", action="store_true",
                    help="paper-faithful: one AllReduce per dot product")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; the CPU runs the kernels' "
                         "plain versions)")
    ap.add_argument("--dist-backend", default=None, choices=list(dist.BACKENDS),
                    help="torch.distributed backend under torchrun (default nccl on the "
                         "card, one rank per card; gloo on the CPU, or to share a card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the problem (seed) and the manufactured solution (seed+1)")
    ap.add_argument("--obs", action="store_true",
                    help="observability: spans + metrics + a run bundle "
                         "results/runs/<run_id>/{manifest.json,events.jsonl,trace.json} "
                         "(trace.json loads in Perfetto)")
    ap.add_argument("--profile", action="store_true",
                    help="run under torch.profiler into <run_dir>/torch_profile (implies "
                         "--obs); fails if a run on the card records no device activity")
    ap.add_argument("--run-dir", default=None,
                    help="bundle directory override (implies --obs; default "
                         "results/runs/<run_id>)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def main(argv=None) -> dict:
    """Run the solve; returns the numbers it printed."""
    args = parse_args(argv)
    if args.nrhs < 1:
        raise SystemExit("--nrhs must be >= 1")
    if args.refine:
        if args.nrhs > 1:
            raise SystemExit("--refine is single-RHS; drop --nrhs")
        if (args.solver, args.backend, args.precond) != ("bicgstab", "spmd", "none"):
            raise SystemExit("--refine drives its own inner bicgstab/spmd solves and does "
                             "not honor --solver/--backend/--precond; drop those flags")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")
    own_group = dist.launched() and not dist.initialized()
    device = join_ranks(args.dist_backend, args.device)
    args.obs = args.obs or args.profile or args.run_dir is not None
    with root_prints():
        out = (obs_manifest.run_bundled("solve", args, device, run) if args.obs
               else run(args, device))
    if own_group:
        leave_ranks()
    return out


def leave_ranks() -> None:
    """Wait for every rank (rank 0 may still be writing the run bundle),
    then leave the group: a rank whose process exits with the group still
    up can abort in the group's threads while its peers still run."""
    dist.barrier()
    dist.shutdown()


def join_ranks(backend: str | None, device_type: str) -> torch.device:
    """This process's device: under ``torchrun``, after joining the group
    (rank 0 then prints the rank-to-device map); else ``device_type``."""
    if not dist.launched():
        return resolve_device(device_type)
    try:
        device = dist.init(backend, device_type=device_type)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if dist.is_root():
        print(f"ranks on {dist.backend()}: " + " ".join(
            f"{r}:{d}" for r, d in enumerate(dist.describe()["rank_devices"])))
    return device


@contextlib.contextmanager
def root_prints():
    """Standard output of every rank but 0 is dropped."""
    if dist.is_root():
        yield
        return
    with contextlib.redirect_stdout(io.StringIO()):
        yield


def _true_rel_residual(cf: stencil.StencilCoeffs, x: torch.Tensor, b: torch.Tensor) -> float:
    """||b - A x|| / ||b||: A x in f32 through the plain apply, norms in f64."""
    ax = stencil.apply_ref(cf.astype(torch.float32), x.to(torch.float32))
    r = b.double() - ax.double()
    del ax
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b.double()))


def _true_rel_residuals_ranks(cf: stencil.StencilCoeffs, x: torch.Tensor, b: torch.Tensor,
                              fabric: FabricAxes) -> list[float]:
    """Per RHS ``||b - A x|| / ||b||`` across the ranks: A x in f32 through
    the plain halo-exchange apply on this rank's block, the f64 sums of
    squares of every RHS summed in one AllReduce."""
    ax = local_apply(cf.astype(torch.float32), x.to(torch.float32), fabric, policy=precision.F32)
    nb = b.ndim - cf.ndim
    r = b.double() - ax.double()
    del ax
    dims = tuple(range(nb, r.ndim))
    sums = torch.stack([r.square().sum(dims), b.double().square().sum(dims)], dim=-1)
    del r
    tot = dist.all_reduce_sum(sums.reshape(-1, 2)).cpu()
    return [float(torch.sqrt(t[0] / t[1])) for t in tot]


#: problems whose fields are the same at every point: a rank builds its block
UNIFORM_PROBLEMS = ("poisson", "convdiff", "seismic")


def rank_system(problem: str | None, spec: stencil.StencilSpec, shape, fabric: FabricAxes, *,
                seed: int, device: torch.device, nrhs: int = 1, solver: str = "bicgstab"):
    """(problem name, f32 coefficients, f32 ``x_true``) of this rank's block
    of the seeded system.  A uniform problem is built on the block itself (a
    block of a uniform field is the field on the block); a random one, and
    ``x_true``, are drawn once on rank 0's host generator, exactly as the
    one-rank run draws them, and rank 0 hands each rank its block, so no
    other rank ever holds the global arrays."""
    local = tuple(s // n for s, (_, _, n) in zip(shape, fabric.split_info(len(shape))))
    root = dist.is_root()
    cpu = torch.device("cpu")
    name = default_problem(problem, spec, solver)

    def scatter(full, lead=()):
        """Rank 0's ``full`` array (leading axes ``lead``) block by block."""
        blocks = None if full is None else [
            full[(slice(None),) * len(lead) + block_slices(fabric.at_rank(r), tuple(shape))]
            for r in range(fabric.size)]
        return dist.scatter_from_root(blocks, lead + local, torch.float32, device)

    if name in UNIFORM_PROBLEMS:
        _, cf = build_problem(name, spec, local, generator=torch.Generator(cpu), device=device,
                              solver=solver)
    else:
        full = manufactured_problem(name, spec, shape, seed=seed, device=cpu,
                                    solver=solver)[1] if root else None
        has_diag = dist.all_gather_object(root and full.diag is not None)[0]
        cf = stencil.StencilCoeffs(
            {n: scatter(full.diags[n] if root else None) for n in spec.names},
            scatter(full.diag if root else None) if has_diag else None)
        del full
    xt = manufactured_solution(shape, seed=seed, device=cpu, nrhs=nrhs) if root else None
    return name, cf, scatter(xt, (nrhs,) if nrhs > 1 else ())


def _check_divides(shape, mesh) -> FabricAxes:
    fabric = FabricAxes.from_mesh(mesh)
    for (dim, _, n), m in zip(fabric.split_info(len(shape)), shape):
        if m % n:
            raise SystemExit(f"--mesh extent {m} on axis {dim} does not divide by the "
                             f"fabric's {n} ranks there ({mesh.shape})")
    return fabric


def run(args: argparse.Namespace, device: torch.device) -> dict:
    shape = tuple(args.mesh)
    spec = stencil.get_spec(args.stencil)
    pol = precision.get_policy(args.policy)
    mesh = make_mesh_for_devices()
    fabric = _check_divides(shape, mesh)
    ranks = fabric.size > 1
    t0 = time.perf_counter()
    if ranks:
        problem, cf, x_true = rank_system(args.problem, spec, shape, fabric, seed=args.seed,
                                          device=device, nrhs=args.nrhs, solver=args.solver)
        synchronize(device)
        setup = dict(system_s=time.perf_counter() - t0)
        b = local_apply(cf, x_true, fabric, policy=precision.F32)
    else:
        problem, cf = manufactured_problem(args.problem, spec, shape, seed=args.seed,
                                           device=device, solver=args.solver)
        synchronize(device)
        t1 = time.perf_counter()
        x_true = manufactured_solution(shape, seed=args.seed, device=device, nrhs=args.nrhs)
        synchronize(device)
        setup = dict(problem_s=t1 - t0, x_true_s=time.perf_counter() - t1)
        b = stencil.rhs_for_solution(cf, x_true)
    dev_name = device_name(device)
    print(f"problem {problem}/{spec.name} (radius {spec.radius}, {spec.n_points} points) "
          f"{shape} on fabric {mesh.shape} solver={args.solver} backend={args.backend} "
          f"schedule={args.schedule} precond={args.precond} policy={pol.name} "
          f"nrhs={args.nrhs} device={dev_name}")
    if args.refine:
        return dict(_refine(mesh, cf, b, x_true, pol, problem, dev_name), **setup)
    del x_true

    bs = b.to(pol.storage)
    labels = dict(solver=args.solver, backend=args.backend, schedule=args.schedule,
                  nrhs=args.nrhs, problem=problem, policy=pol.name)
    before = obs_metrics.collective_counts()
    staged = obs_metrics.counter("comm.host_staged_bytes").value

    synchronize(device)
    t0 = time.perf_counter()
    with obs_trace.span("solve.krylov", **labels) as sp:
        # every rank solves its own block; one rank's block is the system
        solve = bicgstab.solve_block if ranks else bicgstab.solve_distributed
        res = solve(
            mesh, cf, bs, tol=args.tol, maxiter=args.maxiter, policy=pol, solver=args.solver,
            backend=args.backend,
            precond=PrecondConfig(name=args.precond, degree=args.cheb_degree),
            schedule=args.schedule, fused_reductions=not args.paper_separate_reductions)
        sp.block(res.x)
    synchronize(device)
    dt = time.perf_counter() - t0
    after = obs_metrics.collective_counts()
    counts = {k: after[k] - before[k] for k in after}
    staged = obs_metrics.counter("comm.host_staged_bytes").value - staged
    per_rank = dist.all_gather_object(counts) if ranks else None
    collectives = obs_metrics.record_collectives(counts, per_rank=per_rank, **labels)
    emit_solve_metrics(res, wall_s=dt, **labels)
    out = dict(problem=problem, stencil=spec.name, shape=list(shape), policy=pol.name,
               solver=args.solver, backend=args.backend, precond=args.precond,
               nrhs=args.nrhs, device=dev_name, fabric=mesh.shape, ranks=fabric.size,
               iterations=res.iterations.tolist(), converged=res.converged.tolist(),
               breakdown=res.breakdown.tolist(), rel_residual=res.rel_residual.tolist(),
               wall_s=dt, collectives=collectives, **setup)
    most = max(out["iterations"]) if args.nrhs > 1 else out["iterations"]
    out["ms_per_iter"] = dt / max(most, 1) * 1e3
    if ranks:
        out["host_staged_bytes"] = staged       # gloo with card tensors: through the host
        print(f"collectives (executed on each of {fabric.size} ranks): "
              f"allreduce={collectives['allreduce_total']} "
              f"ppermute={collectives['ppermute_total']}, {staged} bytes staged through "
              f"the host on rank 0")
    else:
        print(f"collectives (executed on one rank): "
              f"allreduce={collectives['allreduce_total']} "
              f"ppermute={collectives['ppermute_total']}")
    # achieved share of the card's f32 peak, the paper's accounting (§VII:
    # ~1/3 of peak on the CS-1)
    achieved = (perfmodel.FLOPS_PER_PT * math.prod(shape)
                * int(res.iterations.sum()) / max(dt, 1e-12))
    frac = obs_metrics.roofline_fraction(achieved)
    out["roofline"] = dict(achieved_flops_per_s=achieved, fraction=frac)
    print(f"roofline: {achieved / 1e9:.2f} GFLOP/s achieved on {dev_name}, {frac:.2e} of an "
          f"H100's f32 peak ({perfmodel.PEAK_FLOPS / 1e12:.0f} TFLOP/s, data sheet)")
    x = res.x
    del res, bs          # the solve's state is freed; x and b remain

    # true residual, one RHS at a time (f64 temporaries of a whole batch
    # would be B times as large); across the ranks, one AllReduce
    if ranks:
        true_rel = _true_rel_residuals_ranks(cf, x, b, fabric)
    elif args.nrhs == 1:
        true_rel = [_true_rel_residual(cf, x, b)]
    else:
        true_rel = [_true_rel_residual(cf, x[i], b[i]) for i in range(args.nrhs)]
    if args.nrhs == 1:
        out["true_rel_residual"] = true_rel[0]
        print(f"iterations: {out['iterations']}  converged: {out['converged']}")
        print(f"recurrence rel-residual: {out['rel_residual']:.3e}")
        print(f"true rel-residual (f32 check): {out['true_rel_residual']:.3e}")
        print(f"wall time: {dt:.3f}s ({out['ms_per_iter']:.3f} ms/iter on {dev_name})")
        return out
    out["true_rel_residual"] = true_rel
    print(f"per-RHS iterations: {out['iterations']}")
    print(f"per-RHS converged:  {out['converged']}")
    print("recurrence rel-residuals:", [f"{v:.3e}" for v in out["rel_residual"]])
    print("true rel-residuals (f32 check):", [f"{v:.3e}" for v in out["true_rel_residual"]])
    print(f"wall time: {dt:.3f}s for {args.nrhs} RHS ({out['ms_per_iter']:.3f} ms/iter "
          f"on {dev_name})")
    return out


def _refine(mesh, cf, b, x_true, pol, problem, dev_name) -> dict:
    """``--refine``: f32 iterative refinement around 16-bit inner solves;
    every rank refines its block (``bicgstab.refine_block``; on one rank the
    whole system), and the error against ``x_true`` is the largest of every
    rank's."""
    device = b.device
    ranks = FabricAxes.from_mesh(mesh).size > 1
    before = obs_metrics.collective_counts()
    synchronize(device)
    t0 = time.perf_counter()
    x, rels, inner = bicgstab.refine_block(mesh, cf, b, inner_policy=pol)
    synchronize(device)
    dt = time.perf_counter() - t0
    after = obs_metrics.collective_counts()
    out = dict(problem=problem, stencil=cf.spec.name, shape=list(cf.shape), policy=pol.name,
               device=dev_name, refine_rel_residuals=rels.tolist(), inner_iterations=inner,
               wall_s=dt)
    err = (x - x_true).abs().max()
    if ranks:
        counts = {k: after[k] - before[k] for k in after}
        out.update(collectives=counts, per_rank=dist.all_gather_object(counts))
        err = dist.all_reduce_max(err)
    out["max_err"] = float(err)
    print("refinement true-residual trajectory:",
          [f"{r:.2e}" for r in out["refine_rel_residuals"]])
    if ranks:
        print(f"inner iterations {inner}; collectives (executed on each rank): "
              f"allreduce={counts['allreduce_total']} ppermute={counts['ppermute_total']}")
    print(f"max err vs manufactured solution: {out['max_err']:.3e}  ({dt:.3f}s on {dev_name})")
    return out


if __name__ == "__main__":
    main()
