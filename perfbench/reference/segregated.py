"""Segregated solves of a block of right-hand sides that share one operator.

The momentum predictor of a collocated finite-volume solver solves each
velocity component on the same matrix, one after another: OpenFOAM's
``fvMatrix<Type>::solveSegregated``
(``src/finiteVolume/fvMatrices/fvMatrix/fvMatrixSolve.C``) loops over the
components of ``U``, changing only the source, and each component's answer
is that of a solve of its own.  Here component ``c`` of ``b`` is solved by
the plain BiCGStab of :mod:`perfbench.reference.krylov` on the stored fields
that every component shares, with no batching: what a block solve of the
program is judged against, component by component.
"""

from __future__ import annotations

from typing import Callable

import torch

from perfbench.reference import krylov
from perfbench.reference.precision import Precision


def solve(apply_A: Callable, b: torch.Tensor, *, tol: float, maxiter: int, prec: Precision,
          solver: str = "bicgstab") -> list[krylov.Result]:
    """One plain solve of ``b[c]`` for each component ``c`` of the ``(B,
    ...)`` block ``b``, in order; ``apply_A`` takes one component."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [krylov.SOLVERS[solver](apply_A, b[c], tol=tol, maxiter=maxiter, prec=prec)
            for c in range(b.shape[0])]
