"""SIMPLE drivers: the application loop over the pluggable solver stack.

Counterpart of ``repro/apps/cfd/driver.py``.  One SIMPLE outer iteration
(paper §VI Alg. 2) is: form u/v momentum systems, solve each with a few
Krylov iterations, form the pressure-correction system, solve it,
under-relaxed correct.  Every inner solve goes through the same registries
as ``launch/solve.py`` — ``core.operator`` backends (reference / spmd),
``core.solvers`` and ``core.precond`` — so ``--solver/--backend/--precond/
--policy`` mean the same thing for the CFD application as for the bare
stencil solve.

The 2D fields have no CUDA kernel, as the reference's have no Pallas kernel:
the inner solves run the plain tensor ops of ``reference``/``spmd`` on
whatever device the fields are on, and the ``fused`` backend is refused.

Distribution: with a mesh of more ranks (a 2D fabric that divides ``n``)
every rank runs the whole outer iteration on its block, as the reference's
``shard_map`` body does: formation reads its neighbours' faces through
depth-1 halo exchanges (with corners for the cross-velocity reads), the
inner solves exchange halos and AllReduce their dots, and the residual
maxima and the channel's outlet flux are AllReduces (``core/dist.py``).
Each block knows its offset ``(ox, oy)`` in the grid from its coordinates.
On one rank formation reads the zero-padded halo (the wall value) and every
reduction is the identity.

Transient mode adds the implicit-Euler inertial term and marches
checkpointed time steps through ``checkpoint.CheckpointManager`` +
``runtime.FaultTolerantRunner`` (restart replays bit-identically — the step
is deterministic in the restored state).
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import torch

from repro_torch.apps.cfd.grid import (
    CFDConfig, cell_state, from_staggered, global_indices, to_staggered,
)
from repro_torch.apps.cfd.momentum import (
    AP_FLOOR, divide, form_u_system, form_v_system, window,
)
from repro_torch.apps.cfd.pressure import divergence, form_pressure_system
from repro_torch.core import dist
from repro_torch.core.halo import FabricAxes, gather_blocks, gather_halo, local_block
from repro_torch.core.operator import BACKENDS, make_operator
from repro_torch.core.precond import PrecondConfig, build_precond
from repro_torch.core.solvers import get_solver
from repro_torch.core.stencil import StencilCoeffs
from repro_torch.device import resolve_device, synchronize
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Which pieces of the solver stack the inner solves are routed through.

    ``normalize=True`` is the paper's scheme: rows pre-scaled to unit
    diagonal before the solve ("we only store six other diagonals"), where
    Jacobi preconditioning is the identity.  ``normalize=False`` hands the
    solver the *raw* rows with the stored ``aP`` diagonal — the case where
    ``precond="jacobi"`` does real work through the registry.

    ``schedule`` is the halo communication schedule every inner solve's
    operator is built with (``core.comm.SCHEDULES``).  ``p_solver``
    optionally routes the pressure-correction solve through a different
    registry entry than the momentum solves — the pressure system is the
    iteration-dominant one, so e.g. ``p_solver="pipelined_bicgstab"`` puts
    the single-AllReduce schedule exactly where the sync points are.
    """

    solver: str = "bicgstab"
    backend: str = "reference"
    precond: str | PrecondConfig = "none"
    normalize: bool = True
    cheb_degree: int = 3
    schedule: str = "overlap"
    p_solver: str | None = None

    def precond_config(self) -> PrecondConfig:
        if isinstance(self.precond, PrecondConfig):
            return self.precond
        return PrecondConfig(name=self.precond, degree=self.cheb_degree)

    @property
    def pressure_solver(self) -> str:
        return self.p_solver or self.solver


def _reduce_names(fabric: FabricAxes) -> tuple[str, ...]:
    return tuple(a for a, k in ((fabric.x, fabric.nx), (fabric.y, fabric.ny))
                 if a is not None and k > 1)


def _pmax(x, names):
    """The fabric-wide max (an AllReduce); the identity on one rank."""
    return dist.all_reduce_max(x) if names else x


def _psum(x, names):
    """The fabric-wide sum (an AllReduce); the identity on one rank."""
    return dist.all_reduce_sum(x) if names else x


def _system_coeffs(opts: SolverOptions, policy, system, b):
    """(aP, aE, aW, aN, aS), b -> solver-facing (StencilCoeffs, rhs).

    The normalization divisions run in f32 on the clamped diagonal; only the
    finished coefficients are cast to ``policy.storage`` (the bf16 clamp
    rule — see momentum.py).
    """
    aP, aE, aW, aN, aS = system
    aP = torch.clamp_min(aP, AP_FLOOR)
    if opts.normalize:
        inv = divide(1.0, aP)
        cf = StencilCoeffs({"xp": -aE * inv, "xm": -aW * inv,
                            "yp": -aN * inv, "ym": -aS * inv})
        b = b * inv
    else:
        cf = StencilCoeffs({"xp": -aE, "xm": -aW, "yp": -aN, "ym": -aS},
                           diag=aP)
    return cf.astype(policy.storage), b.to(policy.storage)


def _inner_solve(cfg: CFDConfig, opts: SolverOptions, pconf: PrecondConfig,
                 fabric: FabricAxes, system, b, x0, iters: int,
                 solver: str | None = None):
    """One registry-routed inner solve; returns the f32 solution field.

    ``solver`` overrides ``opts.solver`` (the pressure solve passes
    ``opts.pressure_solver``)."""
    pol = cfg.policy
    # The reference pins formation apart from the solve with an optimization
    # barrier, so XLA cannot fuse (and FMA-contract) across it; eager torch
    # runs every op as written, so formation is materialized here already.
    cf, bs = _system_coeffs(opts, pol, system, b)
    op = make_operator(opts.backend, cf, fabric, policy=pol,
                       schedule=opts.schedule)
    M = build_precond(pconf, op)
    x0 = x0.to(pol.storage)
    res = get_solver(solver or opts.solver)(
        op, bs, x0, tol=cfg.inner_tol, maxiter=iters, policy=pol, precond=M)
    # A truncated solve that ends no nearer b than the zero guess (or not
    # finite) has diverged, and SIMPLE would apply it as a correction: keep
    # the warm start instead.  In bf16 the pressure solve does diverge, and
    # the outer loop then blows up; the reference has no such guard (its
    # jitted driver blows up at bf16_mixed for n=40 and 64, its op-by-op
    # loop for n=24 and 32).
    return torch.where(res.rel_residual < 1.0, res.x, x0).to(torch.float32)


def _step_local(cfg: CFDConfig, opts: SolverOptions, pconf: PrecondConfig,
                fabric: FabricAxes, red: tuple[str, ...],
                u, v, p, u_t, v_t, ox, oy, *, form_only: bool = False):
    """One SIMPLE outer iteration on the local block (``fabric``/``red``/
    ``ox``/``oy`` say where the block sits in the fabric)."""
    n = cfg.n
    h = 1.0 / n
    gi, gj = global_indices(n, u.shape, ox, oy, device=u.device)

    # ---- formation halos (old fields; corners for cross-velocity reads) --
    up = gather_halo(u, fabric, 1, corners=True)
    vp = gather_halo(v, fabric, 1, corners=True)
    pp = gather_halo(p, fabric, 1)
    aPu, aEu, aWu, aNu, aSu, bu, du = form_u_system(cfg, up, vp, pp, u, u_t, gi, gj)
    aPv, aEv, aWv, aNv, aSv, bv, dv = form_v_system(cfg, up, vp, pp, v, v_t, gi, gj)

    if form_only:
        # benchmark slice: all three systems formed, nothing solved — the
        # continuity rows are formed from the unstarred field
        usp = gather_halo(u, fabric, 1)
        vsp = gather_halo(v, fabric, 1)
        div0 = divergence(cfg, u, v, usp, vsp, gi)
        dup = gather_halo(du, fabric, 1)
        dvp = gather_halo(dv, fabric, 1)
        psys = form_pressure_system(cfg, du, dv, dup, dvp, div0, gi, gj)
        parts = (aPu, bu, du, aPv, bv, dv) + psys
        return _psum(sum(a.sum() for a in parts), red)

    # ---- momentum predictors ---------------------------------------------
    u_star = _inner_solve(cfg, opts, pconf, fabric,
                          (aPu, aEu, aWu, aNu, aSu), bu, u,
                          cfg.inner_iters_mom)
    v_star = _inner_solve(cfg, opts, pconf, fabric,
                          (aPv, aEv, aWv, aNv, aSv), bv, v,
                          cfg.inner_iters_mom)
    mom_res_u = _pmax((u_star - u).abs().max(), red)

    if cfg.scenario == "channel":
        # global mass defect folded onto the zero-gradient outlet faces so
        # the pressure correction sees a solvable (net-zero-source) system
        influx = torch.tensor(cfg.u_in, dtype=torch.float32, device=u.device)
        out_faces = torch.where(gi == n - 1, u_star, 0.0)
        outflux = h * _psum(out_faces.sum(), red)
        u_star = torch.where(gi == n - 1,
                             u_star + divide(influx - outflux, n * h), u_star)

    # ---- pressure correction ---------------------------------------------
    usp = gather_halo(u_star, fabric, 1)
    vsp = gather_halo(v_star, fabric, 1)
    div = divergence(cfg, u_star, v_star, usp, vsp, gi)
    dup = gather_halo(du, fabric, 1)
    dvp = gather_halo(dv, fabric, 1)
    aPp, aEp, aWp, aNp, aSp, bp = form_pressure_system(
        cfg, du, dv, dup, dvp, div, gi, gj)
    p_corr = _inner_solve(cfg, opts, pconf, fabric,
                          (aPp, aEp, aWp, aNp, aSp), bp, torch.zeros_like(p),
                          cfg.inner_iters_p, solver=opts.pressure_solver)

    # ---- under-relaxed corrections ---------------------------------------
    pcp = gather_halo(p_corr, fabric, 1)
    u_new = u_star + du * (p_corr - window(pcp, 1, 0))
    v_new = v_star + dv * (p_corr - window(pcp, 0, 1))
    p_new = p + cfg.alpha_p * p_corr
    cont_res = _pmax(div.abs().max(), red)
    return u_new, v_new, p_new, cont_res, mom_res_u


def _validate(cfg: CFDConfig, opts: SolverOptions, mesh) -> None:
    from repro_torch.core.comm import SCHEDULES
    from repro_torch.core.solvers import SOLVERS

    if opts.backend not in BACKENDS:
        raise KeyError(f"unknown backend {opts.backend!r}; have {sorted(BACKENDS)}")
    if opts.schedule not in SCHEDULES:
        raise KeyError(f"unknown comm schedule {opts.schedule!r}; "
                       f"have {sorted(SCHEDULES)}")
    for s in (opts.solver, opts.pressure_solver):
        if s not in SOLVERS:
            raise KeyError(f"unknown solver {s!r}; have {sorted(SOLVERS)}")
    if opts.backend == "fused":
        raise NotImplementedError(
            "the 2D CFD fields have no CUDA kernel yet; use backend='spmd' "
            "(same halo path, plain tensor local apply)")
    if mesh is not None and opts.backend == "reference" and mesh.size > 1:
        raise ValueError(
            "backend='reference' is single-address-space only; use "
            "backend='spmd' on a multi-rank mesh")


def _rank_step(cfg: CFDConfig, opts: SolverOptions, mesh, *, form_only: bool = False):
    """``(step, fabric)``: one SIMPLE outer iteration on this rank's blocks,
    and the fabric it runs on (None on one rank, where a block is the whole
    grid)."""
    _validate(cfg, opts, mesh)
    pconf = opts.precond_config()
    if mesh is None or opts.backend == "reference" or mesh.size == 1:
        fabric = FabricAxes()

        def step(u, v, p, u_t, v_t):
            return _step_local(cfg, opts, pconf, fabric, _reduce_names(fabric), u, v, p,
                               u_t, v_t, 0, 0, form_only=form_only)

        return step, None
    fabric = FabricAxes.from_mesh(mesh)
    if fabric.nz > 1:
        raise ValueError("the 2D CFD app needs a 2D fabric (no pod axis)")
    if cfg.n % fabric.nx or cfg.n % fabric.ny:
        raise ValueError(f"n={cfg.n} must divide the fabric {fabric.nx}x{fabric.ny}")
    dist.check_fabric(fabric.size)
    bx, by = cfg.n // fabric.nx, cfg.n // fabric.ny
    ox, oy = fabric.coords[0] * bx, fabric.coords[1] * by
    red = _reduce_names(fabric)

    def step(u, v, p, u_t, v_t):
        return _step_local(cfg, opts, pconf, fabric, red, u, v, p, u_t, v_t, ox, oy,
                           form_only=form_only)

    return step, fabric


def _blocks(fabric: FabricAxes | None, *fields):
    return fields if fabric is None else tuple(local_block(f, fabric) for f in fields)


def _gathered(fabric: FabricAxes | None, *fields):
    return fields if fabric is None else tuple(gather_blocks(f, fabric) for f in fields)


def make_step_fn(cfg: CFDConfig, opts: SolverOptions = SolverOptions(),
                 mesh=None, *, form_only: bool = False):
    """One SIMPLE outer iteration as a plain callable.

    Returns ``step(u, v, p, u_t, v_t) -> (u, v, p, cont_res, mom_res_u)``
    on cell-shaped fields (``u_t``/``v_t`` are the previous time level,
    ignored when ``cfg.dt is None`` — pass the current fields); with
    ``form_only`` it forms all three systems and returns their checksum.
    It runs on the fields' device.  With a mesh of more ranks the fields
    are global: every rank takes its block, and the new fields are gathered
    back to every rank.
    """
    step, fabric = _rank_step(cfg, opts, mesh, form_only=form_only)
    if fabric is None:
        return step

    def global_step(u, v, p, u_t, v_t):
        out = step(*_blocks(fabric, u, v, p, u_t, v_t))
        if form_only:
            return out
        return (*_gathered(fabric, *out[:3]), *out[3:])

    return global_step


# ---------------------------------------------------------------------------
# Steady drivers (and the legacy core.simple_cfd surface)
# ---------------------------------------------------------------------------

def solve_steady(cfg: CFDConfig, opts: SolverOptions = SolverOptions(),
                 mesh=None, *, device: str | torch.device = "cuda"):
    """Run SIMPLE to convergence on ``device`` (the card unless the caller
    asks for the CPU); returns cell-shaped (u, v, p, history)."""
    cfg = dataclasses.replace(cfg, dt=None)
    step, fabric = _rank_step(cfg, opts, mesh)
    u, v, p = _blocks(fabric, *cell_state(cfg, device=resolve_device(device)))
    history = []
    for i in range(cfg.outer_iters):
        with obs_trace.span("cfd.outer", i=i, solver=opts.solver,
                            backend=opts.backend) as sp:
            u, v, p, res, mres = step(u, v, p, u, v)
            res = sp.block(res)
        obs_metrics.counter("cfd.outer_iterations").inc()
        obs_metrics.gauge("cfd.continuity_res").set(float(res))
        obs_metrics.gauge("cfd.mom_res_u").set(float(mres))
        history.append(float(res))
        if history[-1] < cfg.tol:
            break
    obs_metrics.event("cfd_steady", scenario=cfg.scenario, n=cfg.n,
                      outer_iterations=len(history),
                      continuity_res=history[-1] if history else None,
                      converged=bool(history and history[-1] < cfg.tol))
    u, v, p = _gathered(fabric, u, v, p)
    return u, v, p, history


def solve_cavity(cfg: CFDConfig, opts: SolverOptions = SolverOptions(),
                 mesh=None, *, device: str | torch.device = "cuda"):
    """Legacy surface: staggered (u, v, p, history) of the steady cavity."""
    u, v, p, history = solve_steady(cfg, opts, mesh, device=device)
    u_stag, v_stag = to_staggered(u, v)
    return u_stag, v_stag, p, history


def simple_step(cfg: CFDConfig, u, v, p, *, opts: SolverOptions = SolverOptions()):
    """Legacy surface: one SIMPLE iteration on *staggered* fields, on their
    device.

    Same signature/returns as the seed's ``core.simple_cfd.simple_step``;
    the body routes through the registry stack (reference backend).
    """
    uc, vc = from_staggered(u, v)
    un, vn, pn, res, mres = _step_local(
        cfg, opts, opts.precond_config(), FabricAxes(), (),
        uc, vc, p, uc, vc, 0, 0)
    us, vs = to_staggered(un, vn)
    return us, vs, pn, res, {"mom_res_u": mres}


def measure_solve_share(cfg: CFDConfig, opts: SolverOptions, mesh, state, *,
                        reps: int = 3) -> dict:
    """Paper Table II accounting: the fraction of one SIMPLE outer
    iteration spent in the linear solves vs forming the systems, on the
    state's device.

    The full step and a formation-only variant (same halo gathers, same
    three systems, no solves) are timed separately, each ending in a
    device synchronise; the difference is attributed to the solves.  The
    split lands in the observability registry (``cfd.solve_share`` /
    ``cfd.form_share`` gauges plus a ``cfd_solve_share`` event).
    """
    step, fabric = _rank_step(cfg, opts, mesh)
    form = _rank_step(cfg, opts, mesh, form_only=True)[0]
    u, v, p = _blocks(fabric, *state)

    def timed(fn):
        fn(u, v, p, u, v)                 # warm: allocator, library handles
        synchronize(u.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(u, v, p, u, v)
        synchronize(u.device)
        return (time.perf_counter() - t0) / reps

    with obs_trace.span("cfd.measure_solve_share", backend=opts.backend):
        t_full = timed(step)
        t_form = timed(form)
    t_solve = max(t_full - t_form, 0.0)
    solve_share = t_solve / t_full
    obs_metrics.gauge("cfd.step_ms").set(t_full * 1e3)
    obs_metrics.gauge("cfd.solve_share").set(solve_share)
    obs_metrics.gauge("cfd.form_share").set(t_form / t_full)
    split = {
        "backend": opts.backend,
        "precond": (opts.precond if isinstance(opts.precond, str)
                    else opts.precond.name),
        "rows": "unit-diagonal" if opts.normalize else "raw",
        "step_ms": t_full * 1e3,
        "form_ms": t_form * 1e3,
        "solve_ms": t_solve * 1e3,
        "solve_pct": 100.0 * solve_share,
        "form_pct": 100.0 * t_form / t_full,
    }
    obs_metrics.event("cfd_solve_share", **split)
    return split


# ---------------------------------------------------------------------------
# Transient, checkpointed driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TransientConfig:
    """Time-marching knobs: implicit-Euler steps of ``dt``, each stepped to
    (approximate) convergence by ``outers_per_step`` under-relaxed SIMPLE
    outer iterations, checkpointed every ``checkpoint_every`` steps."""

    dt: float = 0.02
    n_steps: int = 50
    outers_per_step: int = 20
    checkpoint_every: int = 10
    max_restarts: int = 3
    async_checkpoint: bool = False


class _StepStream:
    """The runner's data stream for a time march: stateless (step, batch=None)."""

    def iterate(self, start_step: int):
        return ((s, None) for s in itertools.count(start_step))


def make_transient_step(cfg: CFDConfig, tcfg: TransientConfig,
                        opts: SolverOptions = SolverOptions(), mesh=None):
    """``timestep(state) -> (state, metrics)`` advancing one dt (on global
    fields; with a mesh of more ranks each rank marches its block and the
    state is gathered back after the step)."""
    cfg = dataclasses.replace(cfg, dt=tcfg.dt)
    step, fabric = _rank_step(cfg, opts, mesh)

    def timestep(state):
        u, v, p = _blocks(fabric, *state)
        u_t, v_t = u, v
        res = mres = torch.zeros((), dtype=torch.float32, device=u.device)
        with obs_trace.span("cfd.timestep",
                            outers=tcfg.outers_per_step) as sp:
            for i in range(tcfg.outers_per_step):
                with obs_trace.span("cfd.outer", i=i, solver=opts.solver):
                    u, v, p, res, mres = step(u, v, p, u_t, v_t)
                obs_metrics.counter("cfd.outer_iterations").inc()
            res = sp.block(res)
        obs_metrics.counter("cfd.timesteps").inc()
        obs_metrics.gauge("cfd.continuity_res").set(float(res))
        return _gathered(fabric, u, v, p), {"continuity": res, "mom_res_u": mres}

    return timestep


def run_transient(cfg: CFDConfig, tcfg: TransientConfig,
                  opts: SolverOptions = SolverOptions(), mesh=None, *,
                  checkpoint_dir: str | None = None, failure_hook=None,
                  device: str | torch.device = "cuda"):
    """March ``n_steps`` time steps on ``device`` (the card unless the
    caller asks for the CPU); returns (final state, metrics history).

    With ``checkpoint_dir`` the march runs under ``FaultTolerantRunner``:
    periodic (optionally async) checkpoints, restore-and-replay on any step
    failure, and resume-from-latest when the directory already holds a
    checkpoint — long runs survive preemption.  Restart is deterministic:
    the restored state replays to bit-identical fields.
    """
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import FaultTolerantRunner, RunnerConfig

    if checkpoint_dir is not None and dist.world_size() > 1:
        raise NotImplementedError(
            "a checkpointed march runs on one rank: every rank would write the same "
            "checkpoint directory; drop --checkpoint-dir or torchrun")
    timestep = make_transient_step(cfg, tcfg, opts, mesh)
    state = cell_state(cfg, device=resolve_device(device))

    if checkpoint_dir is None:
        metrics = []
        for s in range(tcfg.n_steps):
            state, m = timestep(state)
            metrics.append({"step": s, **{k: float(x) for k, x in m.items()}})
        return state, metrics

    def train_step(params, opt_state, batch):
        new_state, m = timestep(params)
        return new_state, opt_state, m

    runner = FaultTolerantRunner(
        RunnerConfig(total_steps=tcfg.n_steps,
                     checkpoint_every=tcfg.checkpoint_every,
                     max_restarts=tcfg.max_restarts,
                     async_checkpoint=tcfg.async_checkpoint),
        train_step=train_step, data=_StepStream(),
        ckpt=CheckpointManager(checkpoint_dir, keep=3),
        failure_hook=failure_hook)
    final_state, _ = runner.run(state, ())
    # a fault replay re-appends the steps between the restored checkpoint
    # and the failure point; keep one (the replayed, i.e. last) entry per step
    by_step = {m["step"]: m for m in runner.metrics_history}
    return final_state, [by_step[s] for s in sorted(by_step)]
