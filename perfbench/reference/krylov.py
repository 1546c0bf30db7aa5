"""Plain BiCGStab.

Written from the algorithm (van der Vorst's BiCGStab, the paper's Alg. 1),
with the loop's test read on the host each
iteration.  Vectors are stored in the precision's storage, element-wise work runs in its
compute dtype with one rounding per operation, inner products are summed in
its reduce dtype, and the recurrence scalars stay in float32.

It starts from ``x0 = 0`` (``r0 = b``) and stops once the recurrence residual
satisfies ``||r||^2 <= tol^2 ||b||^2``, when a denominator vanishes
(breakdown) or at ``maxiter``.
"""

from __future__ import annotations

import dataclasses

import torch

from perfbench.reference.precision import Precision

EPS = 1e-30


@dataclasses.dataclass
class Result:
    x: torch.Tensor
    iterations: int
    rel_residual: float       # the recurrence residual at exit
    converged: bool
    breakdown: bool


def _axpy(prec: Precision, a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``y + a x`` in the compute dtype, stored."""
    return prec.store(y + a.to(prec.compute) * x)


def _div(num: torch.Tensor, den: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if abs(float(den)) <= EPS:
        return torch.zeros_like(num), True
    return num / den, False


def bicgstab(apply_A, b: torch.Tensor, *, tol: float, maxiter: int,
             prec: Precision) -> Result:
    """BiCGStab: per iteration 2 SpMVs and the three inner-product stages
    ``<r0, s>``; ``<q, y>, <y, y>``; ``<r0, r'>, <r', r'>``."""
    b = prec.store(b)
    x = torch.zeros_like(b)
    r = p = r0 = b
    bnorm2 = prec.dot(b, b)
    rho = bnorm2
    thresh = float(tol) ** 2 * float(bnorm2)
    rr = float(bnorm2)
    n, brk = 0, False
    while rr > thresh and n < maxiter and not brk:
        s = apply_A(p)
        alpha, bad1 = _div(rho, prec.dot(r0, s))
        q = _axpy(prec, -alpha, s, r)
        y = apply_A(q)
        omega, bad2 = _div(prec.dot(q, y), prec.dot(y, y))
        x = _axpy(prec, omega, q, _axpy(prec, alpha, p, x))
        r = _axpy(prec, -omega, y, q)
        rho_new = prec.dot(r0, r)
        rr = float(prec.dot(r, r))
        beta_frac, bad3 = _div(rho_new, rho)
        alpha_frac, bad4 = _div(alpha, omega)
        p = _axpy(prec, beta_frac * alpha_frac, _axpy(prec, -omega, s, p), r)
        rho = rho_new
        n += 1
        brk = bad1 or bad2 or bad3 or bad4
        del s, q, y
    rel = (rr / max(float(bnorm2), EPS)) ** 0.5
    return Result(x, n, rel, rr <= thresh, brk)


#: the reference solver of each name a traffic mix may give under ``solver``
SOLVERS = {"bicgstab": bicgstab}
