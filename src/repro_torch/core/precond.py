"""Right preconditioning (counterpart of ``repro/core/precond.py``).

Both preconditioners are local, so a solve's sync points per iteration are
those of the unpreconditioned loop:

* :class:`JacobiPrecond`: ``M^-1 = D^-1`` from the stored main diagonal.
  The paper's operators are Jacobi-normalized (unit diagonal), so there it
  is the identity; it does work on raw operators with a variable diagonal
  (``stencil.heterogeneous_poisson``).
* :class:`ChebyshevPrecond`: a degree-d Chebyshev polynomial approximation
  of ``A^-1`` on ``[lmin, lmax]`` (the Chebyshev semi-iteration from a zero
  guess), d - 1 SpMVs per application.  The bounds default to Gershgorin
  estimates, reduced over the fabric, with a relative floor on ``lmin``.

The static choices (name, degree, bounds, floor) travel in a
:class:`PrecondConfig`; :func:`build_precond` instantiates it against an
operator.  Every scalar stays a 0-d tensor on the operator's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core.operator import LinearOperator
from repro_torch.core.solvers.common import SolveResult

PRECONDS = ("none", "jacobi", "chebyshev")


@dataclasses.dataclass(frozen=True)
class PrecondConfig:
    """Static preconditioner choices.

    ``lmin``/``lmax`` override the Gershgorin estimate when given;
    ``lmin_floor`` keeps the Chebyshev interval away from a zero Gershgorin
    lower bound (the weakly dominant Poisson case): eigenvalues below the
    floor are left to the outer Krylov solver.
    """

    name: str = "none"
    degree: int = 3
    lmin: float | None = None
    lmax: float | None = None
    lmin_floor: float = 0.05

    def __post_init__(self):
        if self.name not in PRECONDS:
            raise ValueError(f"unknown preconditioner {self.name!r}; have {sorted(PRECONDS)}")
        if self.degree < 1:
            raise ValueError(f"chebyshev degree must be >= 1, got {self.degree}")


def get_precond_config(name_or_config, **overrides) -> PrecondConfig:
    """Normalize a CLI string / None / config into a PrecondConfig."""
    if name_or_config is None:
        name_or_config = "none"
    if isinstance(name_or_config, PrecondConfig):
        return dataclasses.replace(name_or_config, **overrides) if overrides else name_or_config
    return PrecondConfig(name=name_or_config, **overrides)


class IdentityPrecond:
    name = "none"

    def apply(self, v):
        return v


@dataclasses.dataclass(frozen=True)
class JacobiPrecond:
    """Right diagonal scaling: ``M^-1 v = v / diag``."""

    inv_diag: torch.Tensor        # f32
    storage: torch.dtype
    compute: torch.dtype
    name: str = "jacobi"

    @functools.cached_property
    def _inv_diag_c(self) -> torch.Tensor:
        # converted once: the same bits as a conversion in every apply
        return self.inv_diag.to(self.compute)

    def apply(self, v):
        return (v.to(self.compute) * self._inv_diag_c).to(self.storage)

    def apply_inv(self, v):
        """``M v``, the exact inverse of :meth:`apply`: maps warm starts into
        hat space (:func:`warm_start`)."""
        return (v.to(self.compute) / self._inv_diag_c).to(self.storage)


@dataclasses.dataclass(frozen=True)
class ChebyshevPrecond:
    """``M^-1 v ~= A^-1 v`` by the degree-d Chebyshev semi-iteration from
    ``z0 = 0`` with the spectrum in ``[lmin, lmax]`` (degree 1 is
    ``v / theta``).  SpMVs and AXPYs only, no reduction."""

    apply_A: Callable
    degree: int
    lmin: torch.Tensor            # 0-d f32
    lmax: torch.Tensor            # 0-d f32
    storage: torch.dtype
    compute: torch.dtype
    name: str = "chebyshev"

    @functools.cached_property
    def _scalars(self):
        """``1/theta`` and each step's two recurrence weights, in the compute
        dtype, from the f32 recurrence of the JAX package's apply."""
        c = self.compute
        theta = ((self.lmax + self.lmin) / 2).to(torch.float32)
        delta = ((self.lmax - self.lmin) / 2).to(torch.float32)
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        steps = []
        for _ in range(1, self.degree):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            steps.append(((rho_new * rho).to(c), (2.0 * rho_new / delta).to(c)))
            rho = rho_new
        return (1.0 / theta).to(c), steps

    def apply(self, v):
        c, st = self.compute, self.storage
        inv_theta, steps = self._scalars
        r = v.to(c)
        d = r * inv_theta
        z = d
        for a, b in steps:
            r = r - self.apply_A(d.to(st)).to(c)
            d = a * d + b * r
            z = z + d
        return z.to(st)


def gershgorin_bounds(coeffs):
    """Local Gershgorin disc bounds (min over rows of d - R, max of d + R),
    0-d f32 tensors; the fabric-wide extremes come from ``op.reduce_max``."""
    s = None
    for cf in coeffs.diags.values():
        a = cf.to(torch.float32).abs()
        s = a if s is None else s + a
    d = coeffs.diag.to(torch.float32) if coeffs.diag is not None else torch.ones_like(s)
    return torch.min(d - s), torch.max(d + s)


def build_precond(config: PrecondConfig, op: LinearOperator):
    """Instantiate a preconditioner against an operator."""
    if config.name == "none":
        return IdentityPrecond()
    pol = op.policy
    if config.name == "jacobi":
        if op.coeffs.diag is None:
            return IdentityPrecond()   # the family is already unit-diagonal
        return JacobiPrecond(inv_diag=1.0 / op.coeffs.diag.to(torch.float32),
                             storage=pol.storage, compute=pol.compute)
    device = next(iter(op.coeffs.diags.values())).device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    if config.lmin is not None and config.lmax is not None:
        lmin, lmax = f32(config.lmin), f32(config.lmax)
    else:
        lo, hi = gershgorin_bounds(op.coeffs)
        lmax = op.reduce_max(hi) if config.lmax is None else f32(config.lmax)
        if config.lmin is None:
            lmin = torch.maximum(-op.reduce_max(-lo), config.lmin_floor * lmax)
        else:
            lmin = f32(config.lmin)
    return ChebyshevPrecond(apply_A=op.apply, degree=config.degree, lmin=lmin, lmax=lmax,
                            storage=pol.storage, compute=pol.compute)


def warm_start(precond, x0):
    """Translate a real-space warm start into hat space (``x0_hat = M x0``)
    where the preconditioner has an exact inverse; else use it as is."""
    if x0 is None or precond is None:
        return x0
    apply_inv = getattr(precond, "apply_inv", None)
    return x0 if apply_inv is None else apply_inv(x0)


def wrap_right(op: LinearOperator, precond):
    """Right-precondition an operator: ``(wrapped_op, unwrap)`` with
    ``wrapped_op.apply(v) = A(M^-1 v)`` and ``unwrap`` mapping the hat-space
    result back, ``x = M^-1 x_hat``.  The wrapped operator keeps ``op.fused``,
    so BiCGStab keeps its fused passes."""
    if precond is None or isinstance(precond, IdentityPrecond):
        return op, lambda res: res

    wrapped = op.with_apply(lambda v: op.apply(precond.apply(v)))

    def unwrap(res: SolveResult) -> SolveResult:
        return dataclasses.replace(res, x=precond.apply(res.x))

    return wrapped, unwrap
