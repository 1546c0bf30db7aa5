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


#: what every rank runs before the snippet: join the gloo group through a
#: file in the test's temporary directory (no port is shared between xdist
#: workers), then ``RANK``/``WORLD`` name this rank
_RANK_PRELUDE = """
import os, sys
from repro_torch.core import dist
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init("gloo", device_type="cpu", init_method=os.environ["REPRO_TEST_INIT"],
          world=WORLD, rank_id=RANK)
"""


def run_with_ranks(code_or_fn, world: int, tmp_path, *, timeout: int = 300) -> list[str]:
    """Run a snippet, or a module-level function of no arguments, on
    ``world`` gloo ranks on the CPU, each its own process with
    ``OMP_NUM_THREADS=1``; returns every rank's standard output, in rank
    order.  The gloo twin of ``tests/conftest.py::run_with_devices``: the
    group starts from a file in ``tmp_path`` (xdist workers never share a
    port), and any rank's failure fails the call.  A snippet sees ``dist``,
    ``RANK`` and ``WORLD``; a function is pickled by its import path (the
    ``spawn`` start method) and calls ``repro_torch.core.dist`` itself."""
    init = os.path.join(str(tmp_path), "dist_init")
    if os.path.exists(init):
        os.remove(init)
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(world),
               REPRO_TEST_INIT=f"file://{init}", PYTHONPATH=os.path.join(REPO, "src"))
    if callable(code_or_fn):
        return _spawn_ranks(code_or_fn, world, env, timeout)
    code = _RANK_PRELUDE + textwrap.dedent(code_or_fn) + "\ndist.shutdown()\n"
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, errs = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, f"rank {r} failed:\nSTDOUT:{out}\nSTDERR:{errs}"
    finally:
        for p in procs:
            p.kill()
    return outs


def _rank_entry(fn, rank: int, world: int, env: dict, queue) -> None:
    """One spawned rank: join the group, run ``fn`` with its standard output
    captured, and report ``(rank, ok, output)``."""
    import contextlib
    import io
    import traceback

    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    buf = io.StringIO()
    try:
        from repro_torch.core import dist

        dist.init("gloo", device_type="cpu", init_method=env["REPRO_TEST_INIT"],
                  world=world, rank_id=rank)
        with contextlib.redirect_stdout(buf):
            fn()
        dist.shutdown()
        queue.put((rank, True, buf.getvalue()))
    except Exception:       # reported to the parent, which fails the test
        queue.put((rank, False, buf.getvalue() + traceback.format_exc()))


def _spawn_ranks(fn, world: int, env: dict, timeout: int) -> list[str]:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, env, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = {r: (ok, out) for r, ok, out in (queue.get(timeout=timeout) for _ in procs)}
    finally:
        for p in procs:
            p.join(timeout)
            if p.is_alive():
                p.kill()
    bad = {r: out for r, (ok, out) in got.items() if not ok}
    assert not bad, f"ranks failed: {bad}"
    return [got[r][1] for r in range(world)]


def start_with_devices(code: str, n_devices: int, *, strict_bf16: bool = False):
    """Start a JAX snippet on ``n_devices`` fake host devices in the
    background (the non-blocking form of ``tests/conftest.py::
    run_with_devices``), so it runs while gloo ranks run; ``strict_bf16``
    adds ``--xla_allow_excess_precision=false``.  :func:`finish` waits."""
    flags = f"--xla_force_host_platform_device_count={n_devices}"
    if strict_bf16:
        flags += " --xla_allow_excess_precision=false"
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], env=env, cwd=REPO,
                            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish(proc, timeout: int = 600) -> str:
    """Wait for a :func:`start_with_devices` process; its stdout, or fail."""
    try:
        out, errs = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, f"subprocess failed:\nSTDOUT:{out}\nSTDERR:{errs}"
    return out
