"""Stencil-solver CLI: the paper's experiment on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.solve --backend fused
    PYTHONPATH=src python -m repro_torch.launch.solve --backend fused \
        --mesh 608 608 1536 --policy bf16_mixed --tol 0 --maxiter 30
    PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --mesh 8 8 8 --policy f32
    PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --mesh 8 8 8 --nrhs 2
    PYTHONPATH=src python -m repro_torch.launch.solve --solver cg --backend fused
    PYTHONPATH=src python -m repro_torch.launch.solve --precond chebyshev --problem poisson
    PYTHONPATH=src python -m repro_torch.launch.solve --refine

Counterpart of ``python -m repro.launch.solve``, with its flag names and
defaults: builds a diagonally dominant system of the requested stencil shape,
solves it with the chosen Krylov solver through the chosen backend (``fused``
runs the CUDA kernels), optionally right-preconditioned, and reports
iterations, the recurrence and true residuals, and the time per iteration on
the device it ran on.  ``--nrhs B`` solves B right-hand sides as one block
solve and reports each RHS's numbers; ``--refine`` runs 16-bit inner solves
under f32 iterative refinement instead.  It runs on the card unless
``--device cpu`` is given, and refuses to start without one.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import bicgstab, precision, stencil
from repro_torch.core.comm import SCHEDULES
from repro_torch.core.operator import BACKENDS
from repro_torch.core.precond import PRECONDS, PrecondConfig
from repro_torch.core.solvers import SOLVERS
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_for_devices

PROBLEMS = ["convdiff", "random", "poisson", "heterogeneous", "seismic"]


def build_problem(problem: str | None, spec: stencil.StencilSpec, shape, *,
                  generator: torch.Generator, device: torch.device,
                  solver: str = "bicgstab"):
    """(problem name, coefficients) for the requested pair, in f32 on
    ``device``.  The random problems draw from ``generator`` on its own
    device and are moved; the others are built on ``device``."""
    if problem is None:                      # shape-appropriate default
        if solver in ("cg", "pipelined_cg"):
            problem = "poisson"              # CG wants a symmetric operator
        elif spec == stencil.STAR7:
            problem = "convdiff"
        elif spec.pattern == "star":
            problem = "seismic"
        else:
            problem = "random"
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


def parse_args(argv=None) -> argparse.Namespace:
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
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the problem (seed) and the manufactured solution (seed+1)")
    return ap.parse_args(argv)


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
    return run(args, resolve_device(args.device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _true_rel_residual(cf: stencil.StencilCoeffs, x: torch.Tensor, b: torch.Tensor) -> float:
    """||b - A x|| / ||b||: A x in f32 through the plain apply, norms in f64."""
    ax = stencil.apply_ref(cf.astype(torch.float32), x.to(torch.float32))
    r = b.double() - ax.double()
    del ax
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b.double()))


def run(args: argparse.Namespace, device: torch.device) -> dict:
    shape = tuple(args.mesh)
    spec = stencil.get_spec(args.stencil)
    pol = precision.get_policy(args.policy)
    mesh = make_mesh_for_devices()
    t0 = time.perf_counter()
    problem, cf = manufactured_problem(args.problem, spec, shape, seed=args.seed,
                                       device=device, solver=args.solver)
    _sync(device)
    t1 = time.perf_counter()
    x_true = manufactured_solution(shape, seed=args.seed, device=device, nrhs=args.nrhs)
    _sync(device)
    setup = dict(problem_s=t1 - t0, x_true_s=time.perf_counter() - t1)
    b = stencil.rhs_for_solution(cf, x_true)
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"problem {problem}/{spec.name} (radius {spec.radius}, {spec.n_points} points) "
          f"{shape} on fabric {mesh.shape} solver={args.solver} backend={args.backend} "
          f"schedule={args.schedule} precond={args.precond} policy={pol.name} "
          f"nrhs={args.nrhs} device={dev_name}")
    if args.refine:
        return dict(_refine(mesh, cf, b, x_true, pol, problem, dev_name), **setup)
    del x_true

    bs = b.to(pol.storage)

    _sync(device)
    t0 = time.perf_counter()
    res = bicgstab.solve_distributed(
        mesh, cf, bs, tol=args.tol, maxiter=args.maxiter, policy=pol, solver=args.solver,
        backend=args.backend,
        precond=PrecondConfig(name=args.precond, degree=args.cheb_degree),
        schedule=args.schedule, fused_reductions=not args.paper_separate_reductions)
    _sync(device)
    dt = time.perf_counter() - t0
    out = dict(problem=problem, stencil=spec.name, shape=list(shape), policy=pol.name,
               solver=args.solver, backend=args.backend, precond=args.precond,
               nrhs=args.nrhs, device=dev_name,
               iterations=res.iterations.tolist(), converged=res.converged.tolist(),
               breakdown=res.breakdown.tolist(), rel_residual=res.rel_residual.tolist(),
               wall_s=dt, **setup)
    most = max(out["iterations"]) if args.nrhs > 1 else out["iterations"]
    out["ms_per_iter"] = dt / max(most, 1) * 1e3
    x = res.x
    del res, bs          # the solve's state is freed; x and b remain

    # true residual, one RHS at a time (f64 temporaries of a whole batch
    # would be B times as large)
    if args.nrhs == 1:
        out["true_rel_residual"] = _true_rel_residual(cf, x, b)
        print(f"iterations: {out['iterations']}  converged: {out['converged']}")
        print(f"recurrence rel-residual: {out['rel_residual']:.3e}")
        print(f"true rel-residual (f32 check): {out['true_rel_residual']:.3e}")
        print(f"wall time: {dt:.3f}s ({out['ms_per_iter']:.3f} ms/iter on {dev_name})")
        return out
    out["true_rel_residual"] = [_true_rel_residual(cf, x[i], b[i]) for i in range(args.nrhs)]
    print(f"per-RHS iterations: {out['iterations']}")
    print(f"per-RHS converged:  {out['converged']}")
    print("recurrence rel-residuals:", [f"{v:.3e}" for v in out["rel_residual"]])
    print("true rel-residuals (f32 check):", [f"{v:.3e}" for v in out["true_rel_residual"]])
    print(f"wall time: {dt:.3f}s for {args.nrhs} RHS ({out['ms_per_iter']:.3f} ms/iter "
          f"on {dev_name})")
    return out


def _refine(mesh, cf, b, x_true, pol, problem, dev_name) -> dict:
    """``--refine``: f32 iterative refinement around 16-bit inner solves."""
    device = b.device
    _sync(device)
    t0 = time.perf_counter()
    x, rels = bicgstab.solve_refined(cf, b, mesh=mesh, inner_policy=pol)
    _sync(device)
    dt = time.perf_counter() - t0
    out = dict(problem=problem, stencil=cf.spec.name, shape=list(cf.shape), policy=pol.name,
               device=dev_name, refine_rel_residuals=rels.tolist(),
               max_err=float((x - x_true).abs().max()), wall_s=dt)
    print("refinement true-residual trajectory:",
          [f"{r:.2e}" for r in out["refine_rel_residuals"]])
    print(f"max err vs manufactured solution: {out['max_err']:.3e}  ({dt:.3f}s on {dev_name})")
    return out


if __name__ == "__main__":
    main()
