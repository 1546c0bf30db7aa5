"""The SIMPLE step across ranks (``apps/cfd/driver.py``): the Ghia cavity
(n = 24, Re = 100, spmd, Jacobi) on a 2x2 fabric of gloo ranks on the CPU,
against the JAX package's four-device run of the same cell
(``tests/test_apps_cfd.py::test_cavity_ghia_through_registry_spmd_multidevice``).

* It converges (continuity below 5e-6) and passes the Ghia bands.
* ROADMAP §3's noise rule: the port's converged fields stay within 10 x the
  reference's own noise of JAX's four-device fields, the noise being how far
  JAX's four-device spmd run lands from its one-device reference run.
* A short transient march across the ranks is held to JAX's four-device
  march by the same rule; a checkpointed one is refused across ranks.
* An ``n`` the fabric does not divide, and a pod axis, are refused.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import finish, run_with_ranks, start_with_devices  # noqa: E402

N, TOL, OUTER = 24, 5e-6, 250

JAX = """
import numpy as np
from repro.apps.cfd import CFDConfig, SolverOptions, solve_steady
from repro.launch.mesh import make_mesh_for_devices
cfg = CFDConfig(n=%d, reynolds=100.0, outer_iters=%d, tol=%r)
ur, vr, pr, hr = solve_steady(cfg, SolverOptions(backend="reference"))
us, vs, ps, hs = solve_steady(cfg, SolverOptions(backend="spmd", precond="jacobi"),
                              make_mesh_for_devices(4))
from repro.apps.cfd import TransientConfig, run_transient
tcfg = TransientConfig(dt=0.05, n_steps=2, outers_per_step=3)
(tur, tvr, _), _ = run_transient(CFDConfig(n=12, reynolds=100.0), tcfg,
                                 SolverOptions(backend="reference"))
(tus, tvs, _), _ = run_transient(CFDConfig(n=12, reynolds=100.0), tcfg,
                                 SolverOptions(backend="spmd"), make_mesh_for_devices(4))
np.savez(%r, ur=np.asarray(ur), vr=np.asarray(vr), us=np.asarray(us), vs=np.asarray(vs),
         hr=np.asarray(hr), hs=np.asarray(hs), tur=np.asarray(tur), tvr=np.asarray(tvr),
         tus=np.asarray(tus), tvs=np.asarray(tvs))
print("OK")
"""

PORT = """
import json, numpy as np, torch
from repro_torch.apps.cfd import CFDConfig, SolverOptions, centerline_u, solve_steady, to_staggered
from repro_torch.apps.cfd import driver
from repro_torch.launch.cfd import ghia_check
from repro_torch.launch.mesh import make_mesh_for_devices
mesh = make_mesh_for_devices(4)
cfg = CFDConfig(n=%d, reynolds=100.0, outer_iters=%d, tol=%r)
u, v, p, hist = solve_steady(cfg, SolverOptions(backend="spmd", precond="jacobi"), mesh,
                             device="cpu")
ok, report = ghia_check(to_staggered(u, v)[0])
refused = []
for bad, m in ((25, mesh), (24, make_mesh_for_devices(4, pods=2))):
    try:
        driver.make_step_fn(CFDConfig(n=bad), SolverOptions(backend="spmd"), m)
        refused.append("no error")
    except ValueError as e:
        refused.append(str(e))
# the transient march across the ranks (no checkpoints: one rank writes those)
from repro_torch.apps.cfd import TransientConfig, run_transient
tcfg = TransientConfig(dt=0.05, n_steps=2, outers_per_step=3)
(ut, vt, pt), tm = run_transient(CFDConfig(n=12, reynolds=100.0), tcfg,
                                 SolverOptions(backend="spmd"), mesh, device="cpu")
try:
    run_transient(CFDConfig(n=12), tcfg, SolverOptions(backend="spmd"), mesh, device="cpu",
                  checkpoint_dir="unused")
    ckpt = "no error"
except NotImplementedError as e:
    ckpt = str(e)
if RANK == 0:
    np.savez(%r, u=u.numpy(), v=v.numpy(), tu=ut.numpy(), tv=vt.numpy())
    print(json.dumps(dict(hist=hist, ghia=ok, report=report, refused=refused,
                          steps=len(tm), ckpt=ckpt)))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_cfd")
    jax_npz, port_npz = str(tmp / "jax.npz"), str(tmp / "port.npz")
    jax_proc = start_with_devices(JAX % (N, OUTER, TOL, jax_npz), 4)
    outs = run_with_ranks(PORT % (N, OUTER, TOL, port_npz), 4, tmp)
    finish(jax_proc)
    return dict(np.load(port_npz)), dict(np.load(jax_npz)), json.loads(
        outs[0].strip().splitlines()[-1])


def test_cavity_converges_and_passes_ghia(runs):
    _, _, info = runs
    assert info["hist"][-1] < TOL, info["hist"][-5:]
    assert info["ghia"], info["report"]


def test_cavity_held_to_jax_by_its_own_noise(runs):
    port, jax_out, _ = runs
    for f in ("u", "v"):
        noise = np.abs(jax_out[f + "s"] - jax_out[f + "r"]).max()
        gap = np.abs(port[f] - jax_out[f + "s"]).max()
        assert gap <= 10 * noise, (f, gap, noise)


def test_transient_march_across_ranks(runs):
    """Two implicit-Euler steps of three outer iterations from rest on the
    2x2 fabric, held to JAX's four-device march by the same noise rule; a
    checkpointed march is refused across ranks."""
    port, jax_out, info = runs
    assert info["steps"] == 2
    for f in ("u", "v"):
        noise = np.abs(jax_out["t" + f + "s"] - jax_out["t" + f + "r"]).max()
        gap = np.abs(port["t" + f] - jax_out["t" + f + "s"]).max()
        assert gap <= 10 * noise, (f, gap, noise)
    assert "one rank" in info["ckpt"], info["ckpt"]


def test_fabric_must_divide_n_and_be_2d(runs):
    _, _, info = runs
    assert "n=25 must divide the fabric 2x2" in info["refused"][0], info["refused"]
    assert "2D fabric" in info["refused"][1], info["refused"]
