"""CFD application driver: SIMPLE through the pluggable solver stack.

    PYTHONPATH=src python -m repro_torch.launch.cfd --backend spmd --precond jacobi
    PYTHONPATH=src python -m repro_torch.launch.cfd --scenario cavity --raw-coeffs --precond jacobi
    PYTHONPATH=src python -m repro_torch.launch.cfd --scenario channel --dt 0.05 --steps 40 \\
        --checkpoint-dir /tmp/cfd_ckpt
    PYTHONPATH=src python -m repro_torch.launch.cfd --p-solver pipelined_bicgstab --schedule overlap
    PYTHONPATH=src python -m repro_torch.launch.cfd --device cpu --n 12 --outer 60 --no-check
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.cfd --device cpu \
        --n 24 --backend spmd --precond jacobi              # a 2x2 rank fabric

Counterpart of ``python -m repro.launch.cfd``, with its flags and defaults
plus ``--device``.  Steady mode runs the lid-driven cavity (or channel)
SIMPLE loop to convergence and, for the Re=100 cavity, verifies the Ghia et
al. (1982) centerline structure.  Transient mode (``--dt --steps``) marches
implicit-Euler time steps with under-relaxed outer loops per step; with
``--checkpoint-dir`` the run is fault-tolerant and resumable (restart from
the latest checkpoint is automatic and bit-deterministic).

``--solver/--backend/--precond/--policy`` select the same registry entries
as ``launch/solve.py``.  The 2D fields have no CUDA kernel, so only the
``reference`` and ``spmd`` backends are offered.  It runs on the card unless
``--device cpu`` is given, and refuses to start without one.  Under
``torchrun`` (``spmd``) every rank runs the SIMPLE iteration on its block of
a 2D rank fabric that must divide ``--n`` (``--dist-backend`` as in
``launch/solve.py``); rank 0 alone prints and writes the run bundle.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.apps.cfd import (
    CFDConfig, SolverOptions, TransientConfig, centerline_u, run_transient,
    solve_steady, to_staggered,
)
from repro_torch.core import dist, precision
from repro_torch.core.comm import SCHEDULES
from repro_torch.core.precond import PRECONDS
from repro_torch.core.solvers import SOLVERS
from repro_torch.device import device_name, synchronize
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.launch.solve import join_ranks, root_prints
from repro_torch.obs import manifest as obs_manifest


def ghia_check(u_stag) -> tuple[bool, str]:
    """Qualitative Ghia et al. Re=100 centerline structure (coarse-grid band,
    the reference's acceptance band)."""
    cl = centerline_u(u_stag).detach().cpu().double()
    checks = [
        ("return-flow strength -0.30 < min < -0.10", -0.30 < float(cl.min()) < -0.10),
        ("return flow near mid-height", 0.25 < int(cl.argmin()) / len(cl) < 0.75),
        ("lid-adjacent cells dragged (u > 0.4)", float(cl[-1]) > 0.4),
        ("near-stationary bottom (|u| < 0.1)", abs(float(cl[0])) < 0.1),
    ]
    ok = all(passed for _, passed in checks)
    lines = [f"  [{'ok' if passed else 'FAIL'}] {name}" for name, passed in checks]
    return ok, "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.cfd")
    ap.add_argument("--scenario", default="cavity", choices=["cavity", "channel"])
    ap.add_argument("--n", type=int, default=32, help="cells per side")
    ap.add_argument("--re", type=float, default=100.0, help="Reynolds number")
    ap.add_argument("--u-in", type=float, default=1.0, help="channel inflow velocity")
    ap.add_argument("--solver", default="bicgstab", choices=sorted(SOLVERS))
    ap.add_argument("--p-solver", default=None, choices=sorted(SOLVERS),
                    help="route the pressure-correction solve through a "
                         "different solver (e.g. pipelined_bicgstab: 1 "
                         "AllReduce per inner iteration); default: --solver")
    ap.add_argument("--backend", default="spmd", choices=["reference", "spmd"],
                    help="operator backend for the inner solves (the 2D fields "
                         "have no CUDA kernel: both run plain tensor ops)")
    ap.add_argument("--schedule", default="overlap", choices=sorted(SCHEDULES),
                    help="halo communication schedule for the inner-solve "
                         "SpMVs (overlap is bit-identical to blocking)")
    ap.add_argument("--precond", default="none", choices=sorted(PRECONDS))
    ap.add_argument("--cheb-degree", type=int, default=3)
    ap.add_argument("--policy", default="f32", choices=sorted(precision.POLICIES))
    ap.add_argument("--raw-coeffs", action="store_true",
                    help="hand the solver the raw aP-diagonal rows instead of "
                         "pre-normalized unit-diagonal ones (makes --precond "
                         "jacobi do real registry work)")
    ap.add_argument("--outer", type=int, default=400,
                    help="steady outer-iteration cap (or per-step cap, see --dt)")
    ap.add_argument("--tol", type=float, default=5e-6, help="continuity tolerance")
    ap.add_argument("--dt", type=float, default=None,
                    help="time-step size: switches to the transient driver")
    ap.add_argument("--steps", type=int, default=50, help="transient time steps")
    ap.add_argument("--outers-per-step", type=int, default=20)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="transient only: checkpointed fault-tolerant march "
                         "(resumes automatically from the latest checkpoint)")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the Ghia centerline acceptance check")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda)")
    ap.add_argument("--dist-backend", default=None, choices=list(dist.BACKENDS),
                    help="torch.distributed backend under torchrun (default nccl on the "
                         "card, one rank per card; gloo on the CPU, or to share a card)")
    ap.add_argument("--obs", action="store_true",
                    help="observability: spans + metrics + a run bundle "
                         "results/runs/<run_id>/ (or --run-dir)")
    ap.add_argument("--profile", action="store_true",
                    help="run under torch.profiler into <run_dir>/torch_profile "
                         "(implies --obs)")
    ap.add_argument("--run-dir", default=None,
                    help="bundle directory override (implies --obs)")
    return ap


def main(argv=None) -> dict:
    """Run the CFD application; returns what it printed, plus the final
    cell-shaped fields under ``state``."""
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")
    device = join_ranks(args.dist_backend, args.device)
    args.obs = args.obs or args.profile or args.run_dir is not None
    with root_prints():
        if not args.obs:
            return run(args, device)
        return obs_manifest.run_bundled("cfd", args, device, run)


def run(args: argparse.Namespace, device: torch.device) -> dict:
    pol = precision.get_policy(args.policy)
    cfg = CFDConfig(n=args.n, reynolds=args.re, scenario=args.scenario,
                    u_in=args.u_in, outer_iters=args.outer, tol=args.tol,
                    policy=pol)
    opts = SolverOptions(solver=args.solver, backend=args.backend,
                         precond=args.precond, cheb_degree=args.cheb_degree,
                         normalize=not args.raw_coeffs,
                         schedule=args.schedule, p_solver=args.p_solver)
    mesh = make_mesh_for_devices() if args.backend != "reference" else None
    fab = dict(mesh.shape) if mesh is not None else {"local": 1}
    dev_name = device_name(device)
    print(f"SIMPLE {args.scenario} n={args.n} Re={args.re:g} on fabric {fab} "
          f"solver={args.solver} p_solver={opts.pressure_solver} "
          f"backend={args.backend} schedule={args.schedule} "
          f"precond={args.precond} policy={pol.name} "
          f"rows={'raw' if args.raw_coeffs else 'unit-diagonal'} device={dev_name}")
    if args.precond == "jacobi" and not args.raw_coeffs:
        print("note: unit-diagonal rows make jacobi the identity (the paper's "
              "pre-normalization); use --raw-coeffs for real Jacobi work")

    out = dict(scenario=args.scenario, n=args.n, reynolds=args.re, solver=args.solver,
               p_solver=opts.pressure_solver, backend=args.backend, precond=args.precond,
               policy=pol.name, device=dev_name)
    t0 = time.perf_counter()
    if args.dt is not None:
        tcfg = TransientConfig(dt=args.dt, n_steps=args.steps,
                               outers_per_step=args.outers_per_step)
        (u, v, p), metrics = run_transient(cfg, tcfg, opts, mesh,
                                           checkpoint_dir=args.checkpoint_dir,
                                           device=device)
        synchronize(device)
        dt_wall = time.perf_counter() - t0
        last = metrics[-1] if metrics else {}
        out.update(steps=len(metrics), wall_s=dt_wall,
                   continuity=last.get("continuity", float("nan")))
        print(f"{len(metrics)} steps of dt={args.dt:g} in {dt_wall:.1f}s "
              f"({dt_wall / max(len(metrics), 1) * 1e3:.0f} ms/step on {dev_name}); "
              f"final continuity residual {out['continuity']:.3e}")
    else:
        u, v, p, hist = solve_steady(cfg, opts, mesh, device=device)
        synchronize(device)
        dt_wall = time.perf_counter() - t0
        out.update(outer_iterations=len(hist), history=hist, wall_s=dt_wall,
                   converged=hist[-1] < cfg.tol)
        print(f"outer iterations: {len(hist)} (continuity {hist[0]:.2e} -> "
              f"{hist[-1]:.2e}) in {dt_wall:.1f}s on {dev_name}")
        if hist[-1] >= cfg.tol:
            print("WARNING: did not reach --tol within --outer iterations")
    out["state"] = (u, v, p)

    u_stag, _v_stag = to_staggered(u, v)
    if args.scenario == "cavity":
        cl = centerline_u(u_stag).detach().cpu()
        out["centerline"] = cl.tolist()
        print(f"centerline u: min={float(cl.min()):.3f} (Ghia Re=100 fine-grid "
              f"reference ~ -0.21; first-order upwind on {args.n}^2 is diffusive)")
        if not args.no_check and args.dt is None and 90 <= args.re <= 110:
            ok, report = ghia_check(u_stag)
            out["ghia_ok"] = ok
            print("Ghia Re=100 centerline check:")
            print(report)
            if not ok:
                raise SystemExit(1)
    else:
        h = 1.0 / args.n
        out["outflux"] = float(u[-1, :].sum() * h)
        mid = u[args.n // 2, :].detach().cpu()
        print(f"channel: outlet flux {out['outflux']:.4f} (inflow {args.u_in:g}), "
              f"mid-channel profile center/wall = "
              f"{float(mid[args.n // 2]):.3f}/{float(mid[0]):.3f}")
    return out


if __name__ == "__main__":
    main()
