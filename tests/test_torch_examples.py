"""The port's examples on the CPU (``examples/quickstart_torch.py``,
``examples/cfd_cavity_torch.py``) and the ``repro_torch.kernels.stencil7``
deprecation shim.

* The quickstart runs on one rank and on a 2x2 fabric of gloo ranks: the
  bf16 solve converges, and refinement ends below a true residual of 1e-5
  with a max error below 1e-3 (the JAX quickstart reads 2.6e-6 and 9.7e-5
  on the CPU).
* The cavity example runs with the reference backend and with spmd and
  Jacobi: its continuity residual falls to the example's tol (5e-6) and its
  centerline dips below zero, as the JAX example's does.
* The shim warns with ``DeprecationWarning`` on import, as the JAX package's
  does, and re-exports the same objects as ``kernels/stencil_nd/fused.py``.
"""

import importlib
import os
import re
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_port import REPO, run_python, run_with_ranks  # noqa: E402

QUICKSTART = os.path.join(REPO, "examples", "quickstart_torch.py")
CAVITY = os.path.join(REPO, "examples", "cfd_cavity_torch.py")

#: what the quickstart must reach (the JAX quickstart: 2.64e-6, 9.67e-5)
REFINED_RESIDUAL, REFINED_ERR = 1e-5, 1e-3


def _run_script(path: str, *args: str) -> str:
    res = run_python(f"""
        import runpy, sys
        sys.argv = [{path!r}, *{list(args)!r}]
        runpy.run_path({path!r}, run_name="__main__")
    """, env_extra={"OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    return res.stdout


def _check_quickstart(out: str) -> None:
    assert re.search(r"converged=True in \d+ iters", out), out
    m = re.search(r"after refinement: true-residual (\S+), max error (\S+)", out)
    assert m, out
    assert float(m.group(1)) < REFINED_RESIDUAL and float(m.group(2)) < REFINED_ERR, out


def test_quickstart_on_one_rank():
    out = _run_script(QUICKSTART, "--device", "cpu")
    assert "fabric: {'data': 1, 'model': 1} on cpu" in out
    _check_quickstart(out)


def test_quickstart_on_four_gloo_ranks(tmp_path):
    outs = run_with_ranks(f"""
        import runpy, sys
        sys.argv = [{QUICKSTART!r}, "--device", "cpu"]
        runpy.run_path({QUICKSTART!r}, run_name="__main__")
    """, 4, tmp_path)
    assert "fabric: {'data': 2, 'model': 2} on cpu" in outs[0]
    _check_quickstart(outs[0])
    assert all(o == "" for o in outs[1:]), outs[1:]


@pytest.mark.parametrize("flags", [[], ["--backend", "spmd", "--precond", "jacobi"]],
                         ids=["reference", "spmd-jacobi"])
def test_cfd_cavity_example(flags):
    out = _run_script(CAVITY, "--device", "cpu", "--n", "16", "--iters", "200", *flags)
    m = re.search(r"continuity residual (\S+) -> (\S+)\) on cpu", out)
    assert m and float(m.group(2)) <= 5e-6, out
    cl = re.search(r"centerline u: min=(\S+) ", out)
    assert cl and float(cl.group(1)) < 0, out
    assert "flow speed (lid at top):" in out


def test_stencil7_shim_warns_and_reexports():
    from repro_torch.kernels.stencil_nd import fused

    sys.modules.pop("repro_torch.kernels.stencil7", None)
    with pytest.warns(DeprecationWarning, match="repro_torch.kernels.stencil7 is deprecated"):
        shim = importlib.import_module("repro_torch.kernels.stencil7")
    assert shim.ORDER == fused.ORDER == ("xp", "xm", "yp", "ym", "zp", "zm")
    assert shim.stencil7_dot is fused.stencil7_dot
    assert shim.stencil7_two_dots is fused.stencil7_two_dots
