"""Right preconditioning (counterpart of ``repro/core/precond.py``).

This slice ports the identity (``none``) and the wiring every solver goes
through (:func:`build_precond`, :func:`warm_start`, :func:`wrap_right`);
Jacobi and Chebyshev come in a later slice.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.operator import LinearOperator
from repro_torch.core.solvers.common import SolveResult

PRECONDS = ("none",)


@dataclasses.dataclass(frozen=True)
class PrecondConfig:
    """Static preconditioner choices; the JAX package's Chebyshev fields
    (degree, spectral bounds) come with Chebyshev."""

    name: str = "none"

    def __post_init__(self):
        if self.name not in PRECONDS:
            raise ValueError(f"unknown preconditioner {self.name!r}; have {sorted(PRECONDS)}")


def get_precond_config(name_or_config) -> PrecondConfig:
    """Normalize a CLI string / None / config into a PrecondConfig."""
    if isinstance(name_or_config, PrecondConfig):
        return name_or_config
    return PrecondConfig(name="none" if name_or_config is None else name_or_config)


class IdentityPrecond:
    name = "none"

    def apply(self, v):
        return v


def build_precond(config: PrecondConfig, op: LinearOperator):
    """Instantiate a preconditioner against an operator (``none`` is the
    only one :class:`PrecondConfig` accepts so far)."""
    del op
    return IdentityPrecond()


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
    result back, ``x = M^-1 x_hat``."""
    if precond is None or isinstance(precond, IdentityPrecond):
        return op, lambda res: res

    wrapped = op.with_apply(lambda v: op.apply(precond.apply(v)))

    def unwrap(res: SolveResult) -> SolveResult:
        return dataclasses.replace(res, x=precond.apply(res.x))

    return wrapped, unwrap
