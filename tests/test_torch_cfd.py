"""The port's SIMPLE CFD application (``repro_torch.apps.cfd``) against the
JAX package's: grid bookkeeping, system formation, one SIMPLE step, the
driver's validation, the scenario cells and the solve/formation split.

Inputs are numpy arrays made from a seed and handed to both packages.
Tolerances, stated per test:

* grid functions and formation run op by op in both packages (the JAX
  package's eagerly dispatched ops leave XLA nothing to contract), so they
  are held bitwise; against the reference's jitted formation, where XLA
  contracts multiply-adds into FMAs, to 2 f32 ulp of each output's largest
  magnitude over the field (4 for the quotients by the diagonal);
* one SIMPLE step from a seeded state near a SIMPLE iterate: u and v within
  1e-5 absolute, p within 1e-4 of its largest magnitude.  From an arbitrary
  seeded state the truncated inner BiCGStab solves amplify rounding: the
  reference's own step moves by up to 1.8 when one input changes by 1 ulp
  (run this file as a script to print those gaps).

    PYTHONPATH=src python tests/test_torch_cfd.py        # the measured gaps
    PYTHONPATH=src python tests/test_torch_cfd.py bf16   # bf16_mixed divergence
"""

import dataclasses
import functools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.apps.cfd as J  # noqa: E402
import repro_torch.apps.cfd as T  # noqa: E402
from _torch_port import assert_bitwise, assert_ulp_close, to_np, to_t  # noqa: E402
from repro.apps.cfd import driver as jdrv  # noqa: E402
from repro.apps.cfd import grid as jgrid  # noqa: E402
from repro.apps.cfd import momentum as jmom  # noqa: E402
from repro.apps.cfd import pressure as jpres  # noqa: E402
from repro.core import halo as jhalo  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro_torch.apps.cfd import driver as tdrv  # noqa: E402
from repro_torch.apps.cfd import grid as tgrid  # noqa: E402
from repro_torch.apps.cfd import momentum as tmom  # noqa: E402
from repro_torch.apps.cfd import pressure as tpres  # noqa: E402
from repro_torch.core import halo as thalo  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402

N = 12


def smooth_state(n: int, seed: int, amp: float = 0.3):
    """Seeded smooth staggered (u, v) and cell p: a few low sine modes with
    numpy-drawn amplitudes, zero at the boundary faces."""
    rng = np.random.default_rng(seed)

    def field(shape, scale):
        x = np.linspace(0.0, 1.0, shape[0])[:, None]
        y = np.linspace(0.0, 1.0, shape[1])[None, :]
        f = np.zeros(shape)
        for k in range(1, 4):
            for m in range(1, 4):
                f += rng.standard_normal() / (k * m) * np.sin(k * np.pi * x) * np.sin(m * np.pi * y)
        return (scale * f).astype(np.float32)

    return field((n + 1, n), amp), field((n, n + 1), amp), field((n, n), 0.1 * amp)


# ---------------------------------------------------------------------------
# Grid bookkeeping: bitwise
# ---------------------------------------------------------------------------

def test_grid_functions_bitwise():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((N, N)).astype(np.float32)
    v = rng.standard_normal((N, N)).astype(np.float32)
    ju, jv = jgrid.to_staggered(jnp.asarray(u), jnp.asarray(v))
    tu, tv = tgrid.to_staggered(to_t(u), to_t(v))
    assert_bitwise(tu, ju)
    assert_bitwise(tv, jv)
    for a, b in zip(tgrid.from_staggered(tu, tv), jgrid.from_staggered(ju, jv)):
        assert_bitwise(a, b)
    assert_bitwise(tgrid.centerline_u(tu), jgrid.centerline_u(ju))
    for shape, ox, oy in (((N, N), 0, 0), ((4, 6), 8, 6)):
        for a, b in zip(tgrid.global_indices(N, shape, ox, oy),
                        jgrid.global_indices(N, shape, ox, oy)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cfg = tgrid.CFDConfig(n=N)
    for a, b in zip(tgrid.cell_state(cfg, device="cpu"), jgrid.cell_state(jgrid.CFDConfig(n=N))):
        assert a.dtype == torch.float32
        assert_bitwise(a, b)


def test_config_fields_and_defaults_match_the_reference():
    ref = {f.name: f.default for f in dataclasses.fields(jgrid.CFDConfig)}
    port = {f.name: f.default for f in dataclasses.fields(tgrid.CFDConfig)}
    assert list(ref) == list(port)
    assert ref.pop("policy").name == port.pop("policy").name
    assert ref == port
    assert tgrid.SCENARIOS == jgrid.SCENARIOS and tgrid.CavityConfig is tgrid.CFDConfig
    with pytest.raises(ValueError, match="unknown scenario"):
        tgrid.CFDConfig(scenario="pipe")
    assert [f.name for f in dataclasses.fields(tdrv.TransientConfig)] == \
        [f.name for f in dataclasses.fields(jdrv.TransientConfig)]
    assert tdrv.TransientConfig() == tdrv.TransientConfig(
        **dataclasses.asdict(jdrv.TransientConfig()))
    assert dataclasses.asdict(tdrv.SolverOptions()) == dataclasses.asdict(jdrv.SolverOptions())


# ---------------------------------------------------------------------------
# Formation: bitwise op by op, 2 ulp against the jitted reference
# ---------------------------------------------------------------------------

CASES = [(s, dt) for s in ("cavity", "channel") for dt in (None, 0.05)]


def _formation(pkg, cfg, fields):
    """Every formed array of one outer iteration, in a fixed order: the u and
    v systems, the divergence of (u, v), the pressure system from it, and
    the solver-facing coefficients and rhs of the u system (unit-diagonal
    and raw rows, f32 and bf16_mixed storage)."""
    grid, mom, pres, halo, drv, prec = pkg
    u, v, p, ut, vt = fields
    fab = halo.FabricAxes()
    gi, gj = grid.global_indices(cfg.n, tuple(u.shape), 0, 0)
    up = halo.gather_halo(u, fab, 1, corners=True)
    vp = halo.gather_halo(v, fab, 1, corners=True)
    pp = halo.gather_halo(p, fab, 1)
    usys = mom.form_u_system(cfg, up, vp, pp, u, ut, gi, gj)
    vsys = mom.form_v_system(cfg, up, vp, pp, v, vt, gi, gj)
    div = pres.divergence(cfg, u, v, halo.gather_halo(u, fab, 1), halo.gather_halo(v, fab, 1), gi)
    du, dv = usys[6], vsys[6]
    psys = pres.form_pressure_system(cfg, du, dv, halo.gather_halo(du, fab, 1),
                                     halo.gather_halo(dv, fab, 1), div, gi, gj)
    out = list(usys) + list(vsys) + [div] + list(psys)
    for normalize in (True, False):
        for pol in ("f32", "bf16_mixed"):
            cf, b = drv._system_coeffs(drv.SolverOptions(normalize=normalize),
                                       prec.get_policy(pol), usys[:5], usys[5])
            out += [cf.diags[k] for k in ("xp", "xm", "yp", "ym")] + [b]
            if cf.diag is not None:
                out.append(cf.diag)
    return out


JAX_PKG = (jgrid, jmom, jpres, jhalo, jdrv, jprec)
PORT_PKG = (tgrid, tmom, tpres, thalo, tdrv, tprec)


def _inputs(scenario, dt, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [(s * rng.standard_normal((N, N))).astype(np.float32)
            for s in (0.5, 0.5, 0.1, 0.5, 0.5)]
    kw = dict(n=N, reynolds=100.0, scenario=scenario, dt=dt)
    return (jgrid.CFDConfig(**kw), [jnp.asarray(a) for a in arrs],
            tgrid.CFDConfig(**kw), [to_t(a) for a in arrs])


@pytest.mark.parametrize("scenario,dt", CASES)
def test_formation_bitwise_op_by_op(scenario, dt):
    """Each formed array equals the reference's eager (op-by-op) formation
    bit for bit: u, v and pressure systems, the divergence with the channel
    inlet term, the transient term, and the normalized/raw rows cast to
    f32 and bf16 storage."""
    jc, jf, tc, tf = _inputs(scenario, dt)
    ref = _formation(JAX_PKG, jc, jf)
    port = _formation(PORT_PKG, tc, tf)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16 else torch.float32), i
        assert_bitwise(a, b)


#: indices in ``_formation``'s list of d (= h/aP) and of the pressure system
#: built from it: quotients by a diagonal that FMA contraction moved by up to
#: an ulp, then scaled by h, so two roundings more than a multiply-add
QUOTIENTS = {6, 13} | set(range(15, 21))


@pytest.mark.parametrize("scenario,dt", CASES)
def test_formation_within_2ulp_of_the_jitted_reference(scenario, dt):
    """The reference's driver forms inside jit, where XLA contracts
    multiply-adds: each formed array of the momentum systems and the
    divergence within 2 ulp of its largest magnitude over the field, d and
    the pressure system within 4."""
    jc, jf, tc, tf = _inputs(scenario, dt, seed=1)
    ref = jax.jit(lambda *f: _formation(JAX_PKG, jc, f)[:21])(*jf)
    port = _formation(PORT_PKG, tc, tf)[:21]
    for i, (a, b) in enumerate(zip(port, ref)):
        assert_ulp_close(a, b, np.abs(np.asarray(b)).max(), n_ulp=4 if i in QUOTIENTS else 2)


def test_momentum_formation_is_f32_and_clamped_before_storage_cast():
    """The twin of the reference's bf16_mixed regression test: the aP clamp
    and the d = h/aP division run in f32 before the storage cast, so an
    extreme-viscosity diagonal never reaches the solver as zero."""
    cfg = T.CFDConfig(n=8, reynolds=1e30, alpha_u=1.0, policy=tprec.MIXED)
    u, v, p = tgrid.cell_state(cfg, device="cpu")
    fab = thalo.FabricAxes()
    gi, gj = tgrid.global_indices(cfg.n, tuple(u.shape), 0, 0)
    up = thalo.gather_halo(u, fab, 1, corners=True)
    vp = thalo.gather_halo(v, fab, 1, corners=True)
    pp = thalo.gather_halo(p, fab, 1)
    aP, aE, aW, aN, aS, b, du = tmom.form_u_system(cfg, up, vp, pp, u, u, gi, gj)
    assert aP.dtype == torch.float32 and du.dtype == torch.float32
    assert float(aP[1:-1].min()) >= 9e-13       # the floor, up to f32 rounding
    assert torch.isfinite(du).all()
    cf, bs = tdrv._system_coeffs(T.SolverOptions(normalize=False), cfg.policy,
                                 (aP, aE, aW, aN, aS), b)
    assert cf.diag.dtype == torch.bfloat16
    assert float(cf.diag.abs().min()) > 0.0     # no zero diagonal in storage
    # the same bits as the reference's
    jcfg = J.CFDConfig(n=8, reynolds=1e30, alpha_u=1.0, policy=jprec.MIXED)
    ju = jgrid.cell_state(jcfg)
    jfab = jhalo.FabricAxes()
    jgi, jgj = jgrid.global_indices(8, (8, 8), 0, 0)
    jsys = jmom.form_u_system(jcfg, jhalo.gather_halo(ju[0], jfab, 1, corners=True),
                              jhalo.gather_halo(ju[1], jfab, 1, corners=True),
                              jhalo.gather_halo(ju[2], jfab, 1), ju[0], ju[0], jgi, jgj)
    jcf, _ = jdrv._system_coeffs(J.SolverOptions(normalize=False), jcfg.policy, jsys[:5], jsys[5])
    assert_bitwise(cf.diag, jcf.diag)
    # one full mixed-precision step produces finite fields
    us, vs, ps, res, _aux = T.simple_step(T.CavityConfig(n=8, policy=tprec.MIXED),
                                          *T.to_staggered(u, v), p)
    assert torch.isfinite(us).all() and torch.isfinite(ps).all()


# ---------------------------------------------------------------------------
# One SIMPLE step
# ---------------------------------------------------------------------------

STEP_OPTS = {
    "reference": dict(backend="reference"),
    "spmd": dict(backend="spmd"),
    "raw_jacobi": dict(backend="spmd", precond="jacobi", normalize=False),
    "pipelined_p": dict(backend="spmd", p_solver="pipelined_bicgstab"),
}


@functools.cache
def _midrun_base(scenario: str):
    u0, v0, p0, _ = J.solve_steady(J.CFDConfig(n=N, scenario=scenario, outer_iters=40, tol=0.0))
    return (*J.to_staggered(u0, v0), p0)


def midrun_state(scenario: str, seed: int):
    """The reference's state after 40 steady outer iterations from rest (the
    n=12 cavity has converged by then), plus a seeded smooth perturbation
    of amplitude 1e-3 (numpy): staggered u, v and cell p."""
    us0, vs0, p0 = _midrun_base(scenario)
    du, dv, dp = smooth_state(N, seed=seed, amp=1e-3)
    us, vs, p = np.asarray(us0) + du, np.asarray(vs0) + dv, np.asarray(p0) + dp
    us[0], vs[:, 0] = 0.0, 0.0
    return us, vs, p


@pytest.fixture(scope="module")
def midrun_states():
    cache = {}

    def get(scenario, seed=0):
        if (scenario, seed) not in cache:
            cache[scenario, seed] = midrun_state(scenario, seed)
        return cache[scenario, seed]

    return get


def _steps(scenario, kw, state):
    """(reference step, port step) of the staggered ``state``."""
    us, vs, p = state
    ref = J.simple_step(J.CFDConfig(n=N, scenario=scenario), *map(jnp.asarray, state),
                        opts=J.SolverOptions(**kw))
    port = T.simple_step(T.CFDConfig(n=N, scenario=scenario), *map(to_t, state),
                         opts=T.SolverOptions(**kw))
    return ref, port


def _gap(a, b) -> float:
    return float(np.abs(to_np(a).astype(np.float64) - to_np(b)).max())


def _one_ulp(state):
    us, vs, p = state
    return us, vs, np.nextafter(p, np.float32(1)).astype(np.float32)


@pytest.mark.parametrize("scenario", ["cavity", "channel"])
@pytest.mark.parametrize("label", list(STEP_OPTS))
def test_simple_step_matches_reference(midrun_states, scenario, label):
    """One SIMPLE step from the same seeded state through both packages:
    u and v within 1e-5, p within 1e-4 of its largest magnitude, and the
    continuity residual max|div| within 4e-5 h (four velocity faces of
    1e-5 each, times h).  The state is one from which the reference's own
    step is stable (asserted: a 1-ulp change of p moves its u by under a
    quarter of the tolerance); ``test_step_gap_is_the_references_own_noise``
    covers states from which it is not."""
    state = midrun_states(scenario)
    kw = STEP_OPTS[label]
    (ju, jv, jp, jres, jaux), (tu, tv, tp, tres, taux) = _steps(scenario, kw, state)
    jperturbed = J.simple_step(J.CFDConfig(n=N, scenario=scenario),
                               *map(jnp.asarray, _one_ulp(state)), opts=J.SolverOptions(**kw))
    assert _gap(jperturbed[0], ju) < 0.25e-5
    assert tu.shape == (N + 1, N) and tv.shape == (N, N + 1) and tp.shape == (N, N)
    np.testing.assert_allclose(to_np(tu), np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(tv), np.asarray(jv), rtol=0, atol=1e-5)
    scale = np.abs(np.asarray(jp)).max()
    np.testing.assert_allclose(to_np(tp), np.asarray(jp), rtol=0, atol=1e-4 * scale)
    assert float(tres) == pytest.approx(float(jres), rel=0, abs=4e-5 / N)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("label", ["spmd", "raw_jacobi", "pipelined_p"])
def test_step_gap_is_the_references_own_noise(midrun_states, label, seed):
    """From cavity states where the reference's step is itself unstable —
    BiCGStab on the pinned-Neumann pressure system turns rounding into
    updates of up to 1e-3 (seeds 0-3: a 1-ulp change of p moves the
    reference's u by up to 9.5e-4) — the port's gap to the reference is
    held per field to max(tolerance, 10 x the reference's own noise): the
    larger of its 1-ulp gap and the gap between its eager and jitted steps
    (tolerance: 1e-5 for u and v, 1e-4 of p's largest magnitude for p)."""
    state = midrun_states("cavity", seed)
    kw = STEP_OPTS[label]
    ref, port = _steps("cavity", kw, state)
    cfg = J.CFDConfig(n=N)
    perturbed = J.simple_step(cfg, *map(jnp.asarray, _one_ulp(state)), opts=J.SolverOptions(**kw))
    uc, vc = jnp.asarray(state[0])[1:], jnp.asarray(state[1])[:, 1:]
    jit = jdrv.make_step_fn(cfg, J.SolverOptions(**kw))(uc, vc, jnp.asarray(state[2]), uc, vc)
    jit_stag = (*J.to_staggered(jit[0], jit[1]), jit[2])
    pscale = float(np.abs(np.asarray(ref[2])).max())
    for i, tol in enumerate((1e-5, 1e-5, 1e-4 * pscale)):
        noise = max(_gap(perturbed[i], ref[i]), _gap(jit_stag[i], ref[i]))
        assert _gap(port[i], ref[i]) <= max(tol, 10 * noise), (i, _gap(port[i], ref[i]), noise)


def test_step_fn_is_the_legacy_step_on_cell_fields(midrun_states):
    """``make_step_fn`` on cell-shaped fields is ``simple_step`` on their
    staggered form, bit for bit, for both backends (they share ops)."""
    us, vs, p = (to_t(a) for a in midrun_states("cavity"))
    uc, vc = T.from_staggered(us, vs)
    cfg = T.CFDConfig(n=N)
    ref = T.simple_step(cfg, us, vs, p)
    for backend in ("reference", "spmd"):
        out = tdrv.make_step_fn(cfg, T.SolverOptions(backend=backend))(uc, vc, p, uc, vc)
        for a, b in zip(out[:3], (ref[0][1:], ref[1][:, 1:], ref[2])):
            assert_bitwise(a, b)


def test_bf16_outer_loop_equals_the_references_op_by_op_loop():
    """At bf16_mixed the reference's outer iteration run op by op (its
    ``_step_local`` outside the driver's jit: formation unfused, each
    product of bf16 operands exact in the f32 dots) equals the port's bit
    for bit, three outer iterations from rest, inner solves included.  In
    f32 the dots' products round, and XLA's and torch's dot kernels round
    them differently by an ulp, which the pressure solve amplifies."""
    policy = "bf16_mixed"
    jpol, tpol = jprec.get_policy(policy), tprec.get_policy(policy)
    jc, tc = J.CFDConfig(n=N, policy=jpol), T.CFDConfig(n=N, policy=tpol)
    jo, to = J.SolverOptions(backend="spmd"), T.SolverOptions(backend="spmd")
    js = [jnp.zeros((N, N), jnp.float32)] * 3
    ts = list(tgrid.cell_state(tc, device="cpu"))
    for _ in range(3):
        *js, jres, _ = jdrv._step_local(jc, jo, jo.precond_config(), jhalo.FabricAxes(), (),
                                        *js, js[0], js[1], 0, 0)
        *ts, tres, _ = tdrv._step_local(tc, to, to.precond_config(), thalo.FabricAxes(), (),
                                        *ts, ts[0], ts[1], 0, 0)
        for a, b in zip(ts, js):
            assert_bitwise(a, b)
        assert float(tres) == float(jres)


# ---------------------------------------------------------------------------
# Validation, cells, the legacy surface, the solve/formation split
# ---------------------------------------------------------------------------

def test_validate_refuses_what_the_stack_lacks():
    cfg = T.CFDConfig(n=8)
    with pytest.raises(KeyError, match="unknown backend"):
        tdrv.make_step_fn(cfg, T.SolverOptions(backend="nope"))
    with pytest.raises(NotImplementedError, match="no CUDA kernel.*spmd"):
        tdrv.make_step_fn(cfg, T.SolverOptions(backend="fused"))
    with pytest.raises(NotImplementedError, match="spmd"):
        T.solve_steady(cfg, T.SolverOptions(backend="fused"), device="cpu")
    with pytest.raises(KeyError, match="unknown comm schedule"):
        tdrv.make_step_fn(cfg, T.SolverOptions(schedule="eager"))
    with pytest.raises(KeyError, match="unknown solver"):
        tdrv.make_step_fn(cfg, T.SolverOptions(p_solver="gmres"))
    with pytest.raises(KeyError, match="unknown solver"):
        tdrv.make_step_fn(cfg, T.SolverOptions(solver="gmres"))
    assert T.SolverOptions(p_solver="pipelined_bicgstab").pressure_solver == "pipelined_bicgstab"
    assert T.SolverOptions().pressure_solver == "bicgstab"
    from repro_torch.launch.mesh import make_mesh_for_devices

    mesh4 = make_mesh_for_devices(4)
    with pytest.raises(ValueError, match="single-address-space"):
        tdrv.make_step_fn(cfg, T.SolverOptions(backend="reference"), mesh4)
    # four ranks need a process group of four (tests/test_torch_dist_cfd.py runs one)
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        tdrv.make_step_fn(cfg, T.SolverOptions(backend="spmd"), mesh4)
    # a one-rank mesh is the unsplit fabric
    tdrv.make_step_fn(cfg, T.SolverOptions(backend="spmd"), make_mesh_for_devices(1))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    cfg = T.CFDConfig(n=8, outer_iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.solve_steady(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.run_transient(cfg, T.TransientConfig(n_steps=1, outers_per_step=1))


def test_legacy_reexport_forwards_to_apps():
    from repro_torch.core import simple_cfd

    assert simple_cfd.simple_step is T.simple_step
    assert simple_cfd.CavityConfig is T.CFDConfig
    assert simple_cfd.centerline_u is T.centerline_u
    assert simple_cfd.solve_steady is T.solve_steady
    import repro.apps.cfd as ref_pkg

    assert set(T.__all__) == set(ref_pkg.__all__)


def test_cfd_cells_are_the_references():
    from repro.configs import cfd_scenarios as jcells
    from repro_torch.configs import cfd_scenarios as tcells

    assert list(tcells.CFD_CELLS) == list(jcells.CFD_CELLS)
    for name, cell in tcells.CFD_CELLS.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(jcells.CFD_CELLS[name])
        cfg, opts, tcfg = tcells.build(cell)
        jcfg, jopts, jtcfg = jcells.build(jcells.CFD_CELLS[name])
        assert cfg.policy.name == jcfg.policy.name
        assert dataclasses.replace(cfg, policy=None) == dataclasses.replace(
            T.CFDConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                           if k != "policy"}), policy=None)
        assert dataclasses.asdict(opts) == dataclasses.asdict(jopts)
        assert (tcfg is None) == (jtcfg is None)
        if tcfg is not None:
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jtcfg)


def test_measure_solve_share_splits_the_step(midrun_states):
    from repro_torch.obs import metrics

    us, vs, p = (to_t(a) for a in midrun_states("cavity"))
    uc, vc = T.from_staggered(us, vs)
    split = tdrv.measure_solve_share(T.CFDConfig(n=N), T.SolverOptions(backend="spmd"),
                                     None, (uc, vc, p), reps=2)
    assert 0.0 < split["solve_pct"] / 100 < 1.0 and 0.0 < split["form_pct"] / 100 < 1.0
    assert split["solve_ms"] + split["form_ms"] == pytest.approx(split["step_ms"])
    assert split["rows"] == "unit-diagonal" and split["precond"] == "none"
    assert metrics.snapshot()["gauges"]["cfd.solve_share"] == pytest.approx(
        split["solve_pct"] / 100)
    assert any(e["event"] == "cfd_solve_share" for e in metrics.events())
    # formation only: the checksum of the three formed systems, the reference's
    jus, jvs, jp = (jnp.asarray(a) for a in midrun_states("cavity"))
    juc, jvc = J.from_staggered(jus, jvs)
    jopts = J.SolverOptions()
    jform = jdrv._step_local(J.CFDConfig(n=N), jopts, jopts.precond_config(), jhalo.FabricAxes(),
                             (), juc, jvc, jp, juc, jvc, 0, 0, form_only=True)
    tform = tdrv.make_step_fn(T.CFDConfig(n=N), form_only=True)(uc, vc, p, uc, vc)
    assert float(tform) == pytest.approx(float(jform), rel=1e-6)


def _gap_table() -> None:
    """Print one SIMPLE step's gap in u, port against reference (its
    op-by-op ``simple_step`` and its jitted step), beside the reference's
    own noise (a 1-ulp change of p, and eager against jitted), from the
    tests' mid-run states and from an arbitrary smooth state."""
    states = [(f"mid-run {seed}", sc, midrun_state(sc, seed))
              for sc in ("cavity", "channel") for seed in range(4)]
    states += [("arbitrary", sc, smooth_state(N, seed=0)) for sc in ("cavity", "channel")]
    for label, scenario, state in states:
        for name, kw in STEP_OPTS.items():
            ref, port = _steps(scenario, kw, state)
            cfg = J.CFDConfig(n=N, scenario=scenario)
            ulp = J.simple_step(cfg, *map(jnp.asarray, _one_ulp(state)), opts=J.SolverOptions(**kw))
            uc, vc = jnp.asarray(state[0])[1:], jnp.asarray(state[1])[:, 1:]
            jit = jdrv.make_step_fn(cfg, J.SolverOptions(**kw))(uc, vc, jnp.asarray(state[2]),
                                                                uc, vc)
            print(f"{label:10s} {scenario:7s} {name:11s} port-ref {_gap(port[0], ref[0]):.1e} "
                  f"port-jit {_gap(port[0][1:], jit[0]):.1e}  ref 1-ulp {_gap(ulp[0], ref[0]):.1e} "
                  f"ref eager-jit {_gap(ref[0][1:], jit[0]):.1e}")


def _bf16_table() -> None:
    """Print, per grid size, the first outer iteration whose continuity
    residual exceeds 1 in 50 at bf16_mixed from rest (None: never): the
    reference's jitted driver, the reference's op-by-op loop, and the port
    (whose driver keeps a diverged inner solve's warm start), with the
    port's largest residual and the share of its inner solves that kept
    their warm start."""
    from repro_torch.core.solvers import get_solver

    first = lambda hist: next((i for i, r in enumerate(hist) if not r < 1.0), None)
    for n in (16, 24, 32, 40, 48, 64):
        jc = J.CFDConfig(n=n, outer_iters=50, tol=0.0, policy=jprec.MIXED)
        tc = T.CFDConfig(n=n, outer_iters=50, tol=0.0, policy=tprec.MIXED)
        *_, jit_hist = J.solve_steady(jc, J.SolverOptions(backend="spmd"))
        opts = J.SolverOptions(backend="spmd")
        state, eager_hist = [jnp.zeros((n, n), jnp.float32)] * 3, []
        while len(eager_hist) < 50 and first(eager_hist) is None:
            *state, res, _ = jdrv._step_local(jc, opts, opts.precond_config(), jhalo.FabricAxes(),
                                              (), *state, state[0], state[1], 0, 0)
            eager_hist.append(float(res))
        solves = {"all": 0, "kept": 0}

        def counting(name):
            solver = get_solver(name)

            def run(op, b, x0=None, **kw):
                out = solver(op, b, x0, **kw)
                solves["all"] += 1
                solves["kept"] += int(not bool(out.rel_residual < 1.0))
                return out
            return run

        tdrv.get_solver, saved = counting, tdrv.get_solver
        try:
            *_, port_hist = T.solve_steady(tc, T.SolverOptions(backend="spmd"), device="cpu")
        finally:
            tdrv.get_solver = saved
        print(f"n={n:3d} reference jitted {first(jit_hist)}  op by op {first(eager_hist)}  "
              f"port {first(port_hist)} (max {max(port_hist):.2e}, "
              f"{solves['kept']} of {solves['all']} solves kept their warm start)")


if __name__ == "__main__":
    sys.exit(_bf16_table() if sys.argv[1:] == ["bf16"] else _gap_table())
