"""Solve entry points: wire the rank mesh, operator backend, preconditioner and solver.

Counterpart of ``repro/core/bicgstab.py``:

* :func:`solve_ref`: single-address-space solve (the oracle; with
  ``backend="fused"`` the same solve through the kernels);
* :func:`solve_distributed`: the paper's run, every rank executing the whole
  Krylov iteration on its block, on global arrays (each rank takes its
  block by its fabric coordinates, and ``x`` is gathered back);
* :func:`solve_block`: the same solve on this rank's block alone, so that
  no rank but the one drawing a system ever holds the global arrays (the
  CLI's entry);
* :func:`make_iteration_fn`: one BiCGStab iteration as a plain function
  (the unit the paper measures);
* :func:`solve_refined`: 16-bit inner solves with f32 iterative refinement,
  and :func:`refine_block`, the same on this rank's block alone;
* :func:`solve_ref_fused`: one block through the 7-point SpMV+dot epilogue
  kernels and the fused update passes (the per-chip reference schedule).

``b`` of shape ``coeffs.shape`` is one right-hand side; ``(B,) +
coeffs.shape`` is a batch of B solved as one block solve, with per-RHS
iteration counts and ``[B]`` results.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dist
from repro_torch.core.comm import get_schedule
from repro_torch.core.halo import (
    FabricAxes, gather_blocks, local_apply, local_block, local_coeffs,
)
from repro_torch.core.operator import make_operator
from repro_torch.core.precision import F32, MIXED, Policy
from repro_torch.core.precond import PrecondConfig, build_precond, get_precond_config
from repro_torch.core.solvers import get_solver
from repro_torch.core.solvers.bicgstab import bicgstab_fused_step, bicgstab_step
from repro_torch.core.solvers.common import EPS, SolveResult, axpy_family
from repro_torch.core.stencil import StencilCoeffs, apply_ref
from repro_torch.obs import trace as obs_trace


def _check_rhs(coeffs: StencilCoeffs, b: torch.Tensor) -> None:
    nb = b.ndim - coeffs.ndim
    if nb not in (0, 1) or tuple(b.shape[nb:]) != coeffs.shape:
        raise ValueError(f"b must have shape {coeffs.shape} or (B,) + {coeffs.shape}, "
                         f"got {tuple(b.shape)}")


def solve_ref(coeffs: StencilCoeffs, b: torch.Tensor, x0: torch.Tensor | None = None, *,
              tol: float = 1e-6, maxiter: int = 200, policy: Policy = F32,
              record_history: bool = False, solver: str = "bicgstab",
              backend: str = "reference", precond: str | PrecondConfig | None = None,
              schedule: str | None = None) -> SolveResult:
    """Single-address-space solve; ``backend="fused"`` runs it through the
    kernels on a 1x1 fabric (every collective degenerate)."""
    _check_rhs(coeffs, b)
    op = make_operator(backend, coeffs, policy=policy, schedule=schedule)
    M = build_precond(get_precond_config(precond), op)
    return get_solver(solver)(op, b, x0, tol=tol, maxiter=maxiter, policy=policy,
                              record_history=record_history, precond=M)


def cg_ref(coeffs: StencilCoeffs, b: torch.Tensor, **kw) -> SolveResult:
    """CG through :func:`solve_ref` (``x0`` is ignored, as in the JAX package)."""
    return solve_ref(coeffs, b, solver="cg", **{k: v for k, v in kw.items() if k != "x0"})


def _refuse_reference(backend: str, fabric: FabricAxes) -> None:
    if backend == "reference" and fabric.size > 1:
        # the reference backend has no halo exchange and local-only dots:
        # each rank would silently solve an unrelated zero-Dirichlet block
        raise ValueError(
            "backend='reference' is single-address-space only; use backend='spmd' or "
            "'fused' on a multi-rank mesh (or solve_ref on the undistributed arrays)")


def solve_block(mesh, coeffs: StencilCoeffs, b: torch.Tensor,
                x0: torch.Tensor | None = None, *, tol: float = 1e-6,
                maxiter: int = 200, policy: Policy = MIXED,
                fused_reductions: bool = True, schedule: str | None = None,
                record_history: bool = False, solver: str = "bicgstab",
                backend: str = "spmd",
                precond: str | PrecondConfig | None = None) -> SolveResult:
    """The Krylov solve on this rank's block of the system: ``coeffs``,
    ``b`` and ``x0`` are the rank's own blocks, and ``x`` comes back as
    its block.  The result's scalars are the same on every rank (every
    reduction is an AllReduce).  On the one-rank mesh the block is the
    whole system."""
    sched = get_schedule(schedule)
    fabric = FabricAxes.from_mesh(mesh)
    _refuse_reference(backend, fabric)
    _check_rhs(coeffs, b)
    with obs_trace.span("solve", solver=solver, backend=backend, shape=tuple(coeffs.shape),
                        nrhs=b.shape[0] if b.ndim > coeffs.ndim else 1):
        with obs_trace.span("solve.cast_fields"):
            cf = coeffs.astype(policy.storage)
        op = make_operator(backend, cf, fabric, policy=policy, schedule=sched,
                           fused_reductions=fused_reductions)
        M = build_precond(get_precond_config(precond), op)
        return get_solver(solver)(op, b, x0, tol=tol, maxiter=maxiter, policy=policy,
                                  record_history=record_history, precond=M)


def solve_distributed(mesh, coeffs: StencilCoeffs, b: torch.Tensor,
                      x0: torch.Tensor | None = None, *, tol: float = 1e-6,
                      maxiter: int = 200, policy: Policy = MIXED,
                      fused_reductions: bool = True, schedule: str | None = None, record_history: bool = False,
                      solver: str = "bicgstab", backend: str = "spmd",
                      precond: str | PrecondConfig | None = None) -> SolveResult:
    """A Krylov solve with the whole iteration on every rank of ``mesh``,
    on global arrays: every rank takes its block by its coordinates, runs
    :func:`solve_block`, and ``x`` is gathered back to every rank.

    ``schedule`` ("blocking" | "overlap") picks the halo schedule.
    ``fused_reductions=False`` is the paper's one AllReduce per dot.

    ``x0=None`` starts from zero without an SpMV.  The JAX package's
    ``solve_distributed`` passes a zero warm start instead and forms
    ``r0 = b - A 0``, which is ``b`` bit for bit, so the solve is the same
    with one kernel launch (and one halo exchange) less.
    """
    fabric = FabricAxes.from_mesh(mesh)
    kw = dict(tol=tol, maxiter=maxiter, policy=policy, fused_reductions=fused_reductions,
              schedule=schedule, record_history=record_history, solver=solver,
              backend=backend, precond=precond)
    _check_rhs(coeffs, b)
    if fabric.size == 1:
        return solve_block(mesh, coeffs, b, x0, **kw)
    _refuse_reference(backend, fabric)
    dist.check_fabric(fabric.size)
    nb = b.ndim - coeffs.ndim
    res = solve_block(mesh, local_coeffs(coeffs, fabric), local_block(b, fabric, nb),
                      None if x0 is None else local_block(x0, fabric, nb), **kw)
    return dataclasses.replace(res, x=gather_blocks(res.x, fabric, nb))


def make_iteration_fn(mesh, *, policy: Policy = MIXED, fused_reductions: bool = True,
                      schedule: str | None = None, backend: str = "spmd"):
    """One BiCGStab iteration as a plain function on the rank mesh:
    ``(coeffs, x, r, p, r0, rho) -> (x, r, p, rho, res2)`` on global arrays
    (each rank takes its block; ``x``, ``r`` and ``p`` are gathered back).

    The unit the paper measures: 2 SpMVs, the AXPYs, the dots and 3 sync
    points (5 with ``fused_reductions=False``).  With ``backend="fused"``
    the body is the fused-kernel dataflow of the solver's loop (2 stencil
    kernels, ``dot_mixed``, the three fused passes, 3 ``reduce_partials``);
    otherwise it is the generic loop's body over ``op.apply``/``op.dots``.
    """
    sched = get_schedule(schedule)
    fabric = FabricAxes.from_mesh(mesh)
    _refuse_reference(backend, fabric)

    def step(coeffs, x, r, p, r0, rho):
        op = make_operator(backend, coeffs, fabric, policy=policy, schedule=sched,
                           fused_reductions=fused_reductions)
        if op.fused is not None:
            out = bicgstab_fused_step(op, policy, x, r, p, r0, rho)
        else:
            out = bicgstab_step(op.apply, op.dots, policy, *axpy_family(policy),
                                x, r, p, r0, rho)
        return out[:5]

    if fabric.size == 1:
        return step
    dist.check_fabric(fabric.size)

    def iteration(coeffs, x, r, p, r0, rho):
        blocks = [local_block(a, fabric) for a in (x, r, p, r0)]
        x, r, p, rho, res2 = step(local_coeffs(coeffs, fabric), *blocks, rho)
        return (*(gather_blocks(a, fabric) for a in (x, r, p)), rho, res2)

    return iteration


def solve_refined(coeffs: StencilCoeffs, b: torch.Tensor, *, mesh=None, outer_iters: int = 4,
                  inner_maxiter: int = 60, inner_tol: float = 1e-3,
                  inner_policy: Policy = MIXED) -> tuple[torch.Tensor, torch.Tensor]:
    """f32-accurate solutions from a 16-bit inner solver (iterative refinement).

    Residuals and the solution accumulate in f32; each correction solve runs
    in ``inner_policy``, through :func:`solve_ref` (reference backend) or,
    with a ``mesh``, on every rank of the mesh: every rank takes its block by
    its coordinates, runs :func:`refine_block`, and ``x`` is gathered back to
    every rank.  Returns the f32 solution and the relative true residual
    before each outer step and after the last (``outer_iters + 1`` values).
    """
    if mesh is not None:
        fabric = FabricAxes.from_mesh(mesh)
        kw = dict(outer_iters=outer_iters, inner_maxiter=inner_maxiter, inner_tol=inner_tol,
                  inner_policy=inner_policy)
        if fabric.size == 1:
            return refine_block(mesh, coeffs, b, **kw)[:2]
        dist.check_fabric(fabric.size)
        x, rels, _ = refine_block(mesh, local_coeffs(coeffs, fabric), local_block(b, fabric),
                                  **kw)
        return gather_blocks(x, fabric), rels

    cf32 = coeffs.astype(torch.float32)
    b32 = b.to(torch.float32)
    x = torch.zeros_like(b32)
    bnorm = torch.clamp(torch.linalg.vector_norm(b32), min=EPS)
    rels = []
    for _ in range(outer_iters):
        r = b32 - apply_ref(cf32, x, policy=F32)
        rels.append(torch.linalg.vector_norm(r) / bnorm)
        d = solve_ref(coeffs, r.to(inner_policy.storage), tol=inner_tol, maxiter=inner_maxiter,
                      policy=inner_policy)
        x = x + d.x.to(torch.float32)
    rels.append(torch.linalg.vector_norm(b32 - apply_ref(cf32, x, policy=F32)) / bnorm)
    return x, torch.stack(rels)


def refine_block(mesh, coeffs: StencilCoeffs, b: torch.Tensor, *, outer_iters: int = 4,
                 inner_maxiter: int = 60, inner_tol: float = 1e-3,
                 inner_policy: Policy = MIXED) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """:func:`solve_refined` on this rank's block: ``coeffs`` and ``b`` are
    the rank's blocks, and ``x`` comes back as its block.

    The f32 residual ``b - A x`` is the block apply after an f32 depth-r
    exchange, and each correction solve :func:`solve_block` (spmd backend).
    On one rank each norm is the f32 norm of the whole array, as the
    meshless form's; on more, each rank's f64 sum of squares is summed
    across the ranks by one AllReduce and its square root rounded to f32.
    Returns ``(x, rels, inner_iterations)``: ``rels`` as
    :func:`solve_refined`'s, and each correction solve's iteration count.
    Per rank and outer step that is ``2 + 3 n`` AllReduces (the residual
    norm, then the inner solve's ``1 + 3 n``), plus two for ``||b||`` and
    the last residual.
    """
    fabric = FabricAxes.from_mesh(mesh)
    dist.check_fabric(fabric.size)
    cf32 = coeffs.astype(torch.float32)

    def norm(v):
        if fabric.size == 1:
            return torch.linalg.vector_norm(v)
        sq = dist.all_reduce_sum(torch.linalg.vector_norm(v, dtype=torch.float64).square())
        return torch.sqrt(sq).to(torch.float32)

    b32 = b.to(torch.float32)
    x = torch.zeros_like(b32)
    bnorm = torch.clamp(norm(b32), min=EPS)
    rels, inner_iterations = [], []
    for _ in range(outer_iters):
        r = b32 - local_apply(cf32, x, fabric, policy=F32)
        rels.append(norm(r) / bnorm)
        d = solve_block(mesh, coeffs, r.to(inner_policy.storage), tol=inner_tol,
                        maxiter=inner_maxiter, policy=inner_policy)
        inner_iterations.append(int(d.iterations))
        x = x + d.x.to(torch.float32)
    rels.append(norm(b32 - local_apply(cf32, x, fabric, policy=F32)) / bnorm)
    return x, torch.stack(rels), inner_iterations


def solve_ref_fused(coeffs: StencilCoeffs, b: torch.Tensor, *, tol: float = 1e-6,
                    maxiter: int = 200) -> SolveResult:
    """BiCGStab on one block through the fused schedule: the 7-point SpMV
    with its dot epilogue twice per iteration, the inline ``q``, then the
    fused ``x``/``r`` update with its dots and the ``p`` update.

    Counterpart of ``repro/core/bicgstab.py:solve_ref_fused``, pass for
    pass: no ``safe_div`` (no breakdown test), the relative residual read
    on the host each iteration and the loop left once it is below ``tol``,
    ``iterations`` the count of the last iteration run.  It runs on the
    device of ``b``; ``coeffs`` must be the unit-diagonal star7 in ``b``'s
    dtype, and the SpMV accumulates in f32.
    """
    from repro_torch.kernels.fused_iter import update_p, update_xr_dots
    from repro_torch.kernels.stencil_nd.fused import stencil7_dot, stencil7_two_dots

    if b.ndim != coeffs.ndim:
        raise ValueError("solve_ref_fused takes one right-hand side")
    x = torch.zeros_like(b)
    r = p = r0 = b
    bf = b.to(torch.float32).reshape(-1)
    bnorm2 = torch.dot(bf, bf)
    del bf
    rho = bnorm2
    n_iter, rel = 0, 1.0
    for n_iter in range(1, maxiter + 1):
        s, r0s = stencil7_dot(coeffs, p, r0)                       # pass 1
        alpha = rho / r0s
        q = r - alpha.to(r.dtype) * s                               # pass 2
        y, qy, yy = stencil7_two_dots(coeffs, q)                    # pass 3
        omega = qy / yy
        x, r, rho_new, rr = update_xr_dots(alpha, omega, x, p, q, y, r0)   # pass 4
        beta = (alpha / omega) * (rho_new / rho)
        p = update_p(beta, omega, r, p, s)                          # pass 5
        rho = rho_new
        rel = float(torch.sqrt(rr / bnorm2))
        if rel < tol:
            break
    return SolveResult(x, torch.tensor(n_iter, dtype=torch.int32),
                       torch.tensor(rel, dtype=torch.float32), torch.tensor(rel < tol),
                       torch.tensor(False))
