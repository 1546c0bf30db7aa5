"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; JAX
arrays cross over as numpy arrays (bfloat16 bits included).
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_t(a):
    """A JAX array or numpy array as a CPU torch tensor, bits unchanged."""
    from repro_torch.device import tensor_from_numpy

    return tensor_from_numpy(np.asarray(a), "cpu")


def to_np(a) -> np.ndarray:
    """A torch tensor or JAX array as a float32-or-wider numpy array
    (bfloat16 widens exactly)."""
    if hasattr(a, "detach"):
        from repro_torch.device import tensor_to_numpy

        return tensor_to_numpy(a)
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def carry_coeffs(cf_jax):
    """A JAX StencilCoeffs carried into the port through ``from_numpy``."""
    from repro_torch.core.stencil import StencilCoeffs

    return StencilCoeffs.from_numpy(
        {n: np.asarray(a) for n, a in cf_jax.diags.items()},
        None if cf_jax.diag is None else np.asarray(cf_jax.diag), device="cpu")


def assert_bitwise(actual, expected) -> None:
    a, e = to_np(actual), to_np(expected)
    assert a.shape == e.shape, (a.shape, e.shape)
    diff = np.flatnonzero(a != e)
    assert diff.size == 0, (f"{diff.size} of {a.size} elements differ; first at flat "
                            f"{diff[0]}: {a.ravel()[diff[0]]!r} vs {e.ravel()[diff[0]]!r}")


def assert_ulp_close(actual, expected, scale, n_ulp: int = 2) -> None:
    """|actual - expected| <= n_ulp float32 ulps of ``scale`` elementwise.

    ``scale`` is the magnitude of the largest intermediate of each element's
    expression (e.g. |v| + sum |c_i w_i| for the stencil): a contracted FMA
    and a separate multiply-add differ by at most one rounding of that size.
    """
    a, e = to_np(actual).astype(np.float64), to_np(expected).astype(np.float64)
    tol = n_ulp * np.spacing(np.abs(np.asarray(scale, np.float64)).astype(np.float32))
    bad = np.abs(a - e) > tol
    assert not bad.any(), (f"{bad.sum()} elements beyond {n_ulp} ulp; worst "
                           f"{np.max(np.abs(a - e) - tol):.3e} over tolerance")


def _run(argv: list[str], env_extra: dict | None, timeout: int):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *argv], env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


def run_python(code: str, *, env_extra: dict | None = None, timeout: int = 300):
    """Run a snippet in a fresh interpreter with ``src`` on the path."""
    return _run(["-c", textwrap.dedent(code)], env_extra, timeout)


def run_module(module: str, *args: str, timeout: int = 300):
    """``python -m module args...`` in a fresh interpreter with ``src`` on the path."""
    return _run(["-m", module, *args], None, timeout)
