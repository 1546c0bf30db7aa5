"""Stencil-solver CLI: the paper's experiment on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.solve --backend fused
    PYTHONPATH=src python -m repro_torch.launch.solve --backend fused \
        --mesh 608 608 1536 --policy bf16_mixed --tol 0 --maxiter 30
    PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --mesh 8 8 8 --policy f32
    PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --mesh 8 8 8 --nrhs 2

Counterpart of ``python -m repro.launch.solve``, with its flag names and
defaults: builds a diagonally dominant system of the requested stencil shape,
solves it by BiCGStab through the chosen backend (``fused`` runs the CUDA
kernels) and reports iterations, the recurrence and true residuals, and the
time per iteration on the device it ran on.  ``--nrhs B`` solves B
right-hand sides as one block solve and reports each RHS's numbers.  It runs
on the card unless ``--device cpu`` is given, and refuses to start without
one.
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
                  generator: torch.Generator):
    """(problem name, coefficients) for the requested pair, built in f32 on
    the generator's device."""
    device = generator.device
    if problem is None:                      # shape-appropriate default
        if spec == stencil.STAR7:
            problem = "convdiff"
        elif spec.pattern == "star":
            problem = "seismic"
        else:
            problem = "random"
    if problem == "random":
        return problem, stencil.random_nonsymmetric(generator, shape, spec=spec)
    if problem == "poisson":
        return problem, stencil.poisson(shape, spec=spec, device=device)
    if problem == "heterogeneous":
        return problem, stencil.heterogeneous_poisson(generator, shape, spec=spec)
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


def manufactured_system(problem: str | None, spec: stencil.StencilSpec, shape, *,
                        seed: int, device: torch.device, nrhs: int = 1):
    """(problem name, f32 coefficients, f32 right-hand side ``b = A x_true``):
    the system is seeded by ``seed``, the solution ``x_true`` by ``seed + 1``.
    ``nrhs > 1`` gives a batch ``(nrhs,) + shape`` of solutions from the same
    generator; ``nrhs == 1`` stays unbatched."""
    gen = torch.Generator(device=device).manual_seed(seed)
    problem, cf = build_problem(problem, spec, shape, generator=gen)
    gen_x = torch.Generator(device=device).manual_seed(seed + 1)
    xshape = (nrhs,) + tuple(shape) if nrhs > 1 else tuple(shape)
    x_true = torch.randn(xshape, generator=gen_x, device=device)
    return problem, cf, stencil.rhs_for_solution(cf, x_true)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.solve")
    ap.add_argument("--mesh", type=int, nargs=3, default=[48, 48, 32],
                    metavar=("X", "Y", "Z"))
    ap.add_argument("--stencil", default="star7", choices=sorted(stencil.SPECS),
                    help="stencil shape: star7 (paper), star13, star25 (seismic RTM), box27")
    ap.add_argument("--solver", default="bicgstab", choices=sorted(SOLVERS))
    ap.add_argument("--backend", default="spmd", choices=sorted(BACKENDS),
                    help="SpMV backend: spmd (halo apply, plain tensor ops), fused "
                         "(CUDA kernels + 3 sync points/iter), reference")
    ap.add_argument("--schedule", default="overlap", choices=sorted(SCHEDULES),
                    help="halo schedule (bit-identical results)")
    ap.add_argument("--precond", default="none", choices=sorted(PRECONDS))
    ap.add_argument("--policy", default="bf16_mixed", choices=sorted(precision.POLICIES))
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=200)
    ap.add_argument("--problem", default=None, choices=PROBLEMS,
                    help="default: convdiff for star7, seismic for deeper stars, "
                         "random for box")
    ap.add_argument("--nrhs", type=int, default=1,
                    help="right-hand sides solved as one block (batched) Krylov solve; "
                         "every sync point reduces the stacked [k, B] partials")
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
    problem, cf, b = manufactured_system(args.problem, spec, shape, seed=args.seed,
                                         device=device, nrhs=args.nrhs)
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"problem {problem}/{spec.name} (radius {spec.radius}, {spec.n_points} points) "
          f"{shape} on fabric {mesh.shape} solver={args.solver} backend={args.backend} "
          f"schedule={args.schedule} precond={args.precond} policy={pol.name} "
          f"nrhs={args.nrhs} device={dev_name}")

    bs = b.to(pol.storage)

    _sync(device)
    t0 = time.perf_counter()
    res = bicgstab.solve_distributed(
        mesh, cf, bs, tol=args.tol, maxiter=args.maxiter, policy=pol, solver=args.solver,
        backend=args.backend, precond=PrecondConfig(name=args.precond),
        schedule=args.schedule, fused_reductions=not args.paper_separate_reductions)
    _sync(device)
    dt = time.perf_counter() - t0
    out = dict(problem=problem, stencil=spec.name, shape=list(shape), policy=pol.name,
               backend=args.backend, nrhs=args.nrhs, device=dev_name,
               iterations=res.iterations.tolist(), converged=res.converged.tolist(),
               breakdown=res.breakdown.tolist(), rel_residual=res.rel_residual.tolist(),
               wall_s=dt)
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


if __name__ == "__main__":
    main()
