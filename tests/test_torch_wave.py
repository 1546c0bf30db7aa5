"""Explicit acoustic wave propagation (``repro_torch.core.wave``) against the
plain reference written from the equations (``tests/_wave_reference.py``).

The JAX package has no explicit time-stepper, so the reference here is the
equations themselves.  On the CPU both backends run K7's plain version
(``kernels/wave/ref.py``); the CUDA kernel is held to it bit for bit on the
card by ``chip_smoke.py`` (phase 15).

Tolerances: the port sums each point's 25 taps in K7's canonical tap order,
the reference axis by axis as the equation is written, so the two round
apart by a few float32 ulps a step; over 40-60 steps the gaps read 1.7e-7 to
3.0e-7 (2-norm) and 0.8e-7 to 2.4e-7 (largest pointwise, over the largest
magnitude).  The limit, 1e-5, is 30 times above them and 200 times below the
nearest control (bf16 wavefield storage: 2.2e-3 to 7.6e-3; the 13-point
Laplacian: 3.9e-2 to 8.0e-2).
"""

import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread per test process (tests/_torch_port.py)

import _wave_reference as ref  # noqa: E402

from repro_torch.core import stencil, wave  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.stencil_nd.kernel import launch_plan as stencil_plan  # noqa: E402
from repro_torch.kernels.wave import kernel as wave_kernel  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

DT, H = 8e-4, 10.0
RICKER = wave.Ricker(10.0, 0.1)
TOL = 1e-5

#: (mesh, source, steps): a source in the middle, an odd Z, and sources within
#: 4 points of a face (x, y and the top z face): the zero halo is read there
CASES = [
    ((20, 18, 24), (10, 9, 10), 50),
    ((17, 13, 21), (8, 6, 10), 60),
    ((20, 18, 24), (2, 9, 10), 50),
    ((20, 18, 24), (10, 16, 3), 40),
]
IDS = ["middle", "odd_z", "near_x_face", "near_y_and_z_faces"]


def _model(shape, seed=0):
    return wave.WaveModel.from_velocity(wave.gradient_velocity(shape, seed=seed, device="cpu"),
                                        dt=DT, h=H)


def _gaps(a, b):
    return (float((a - b).norm() / b.norm()), float((a - b).abs().max() / b.abs().max()))


def _reference(model, source, steps, **kw):
    return ref.shot(model.c, source, ref.ricker(steps, DT, RICKER.peak_hz, RICKER.delay_s),
                    steps, **kw)


@pytest.mark.parametrize("backend", wave.BACKENDS)
@pytest.mark.parametrize("shape, source, steps", CASES, ids=IDS)
def test_shot_matches_reference(shape, source, steps, backend):
    model = _model(shape)
    got = wave.propagate_shot(model, source, RICKER, steps, backend=backend)
    want = _reference(model, source, steps)
    assert not got.failed and got.steps == steps
    assert float(want.abs().max()) > 1e-3          # the wave is there to compare
    l2, worst = _gaps(got.u, want)
    assert l2 < TOL and worst < TOL, (l2, worst)


@pytest.mark.parametrize("control", [dict(storage=torch.bfloat16), dict(radius=2)],
                         ids=["bf16_storage", "fd4_13_point"])
@pytest.mark.parametrize("shape, source, steps", CASES, ids=IDS)
def test_controls_exceed_the_tolerances(shape, source, steps, control):
    model = _model(shape)
    want = _reference(model, source, steps)
    l2, worst = _gaps(_reference(model, source, steps, **control), want)
    assert l2 > 100 * TOL and worst > 100 * TOL, (l2, worst)


def test_backends_agree_bit_for_bit_on_the_cpu():
    """``fused`` on CPU tensors takes K7's wrapper, which runs the plain
    version in place; ``plain`` calls the plain version: the same bits."""
    model = _model((17, 13, 21), seed=3)
    a = wave.propagate_shot(model, (2, 3, 4), RICKER, 30, backend="fused").u
    b = wave.propagate_shot(model, (2, 3, 4), RICKER, 30, backend="plain").u
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_one_step_from_given_wavefields():
    """One step from wavefields everywhere (every tile and face of the
    block), against the reference's; the caller's fields are not written."""
    shape = (19, 14, 23)
    model = _model(shape, seed=5)
    gen = torch.Generator().manual_seed(11)
    u0, w0 = (torch.randn(shape, generator=gen) for _ in range(2))
    keep = u0.clone(), w0.clone()
    got = wave.propagate_shot(model, (9, 7, 11), RICKER, 1, u0=u0, u_prev0=w0)
    want = _reference(model, (9, 7, 11), 1, u0=u0, u_prev0=w0)
    assert torch.equal(u0, keep[0]) and torch.equal(w0, keep[1])
    assert not got.failed
    l2, worst = _gaps(got.u, want)
    assert l2 < 1e-6 and worst < 1e-6, (l2, worst)


def test_spans_and_counters_of_a_shot():
    model = _model((12, 10, 16))
    steps = 7
    trace.reset()
    before = {k: obs_metrics.counter(k).value for k in ("wave.shots", "wave.steps")}
    trace.enable()
    try:
        wave.propagate_shot(model, (6, 5, 8), RICKER, steps)
    finally:
        trace.disable()
    names = [e["name"] for e in trace.events()]
    trace.reset()
    assert names.count("wave.shot") == 1 and names.count("wave.init") == 1
    assert names.count("wave.step") == steps and names.count("wave.flag_wait") == 1
    assert obs_metrics.counter("wave.shots").value == before["wave.shots"] + 1
    assert obs_metrics.counter("wave.steps").value == before["wave.steps"] + steps


def test_cpu_tensors_launch_no_kernel():
    reset_launch_counts()
    wave.propagate_shot(_model((8, 8, 8)), (4, 4, 4), RICKER, 5, backend="fused")
    assert launch_counts()["wave_leapfrog"] == 0


def test_failure_flag():
    model = _model((10, 9, 12))
    u0 = torch.zeros((10, 9, 12))
    u0[3, 3, 3] = float("nan")
    assert wave.propagate_shot(model, (5, 4, 6), RICKER, 3, u0=u0).failed
    assert not wave.propagate_shot(model, (5, 4, 6), RICKER, 3).failed
    # a step whose c makes it unstable grows without bound
    hot = wave.WaveModel(torch.full((10, 9, 12), 4.0), DT, H)
    assert wave.propagate_shot(hot, (5, 4, 6), RICKER, 40).failed


def test_k7_plan_is_k1_star25_f32_plan():
    for shape in [(755, 994, 1000), (17, 13, 21), (48, 48, 32)]:
        assert wave_kernel.launch_plan(shape) == stencil_plan(shape, 1, 24, 4, 4)


def test_weights_velocity_and_wavelet():
    a0, arms = stencil._FD2_WEIGHTS[4]
    w = wave.step_weights()
    assert w[0] == float(torch.tensor(3 * a0, dtype=torch.float32))
    assert w[1:] == tuple(float(torch.tensor(a, dtype=torch.float32)) for a in arms)
    v = torch.tensor([1500.0, 4500.0])
    assert torch.allclose(wave.velocity_to_c(v, dt=DT, h=H),
                          torch.tensor([0.0144, 0.1296]), rtol=1e-6)
    s = RICKER.samples(251, DT, "cpu")
    assert int(s.argmax()) == 125 and float(s[125]) == 1.0
    assert math.isclose(float(s[0]), ref.ricker(1, DT, 10.0, 0.1)[0], rel_tol=1e-6)


def test_gradient_velocity_from_the_seed():
    a = wave.gradient_velocity((12, 10, 30), seed=7, device="cpu")
    b = wave.gradient_velocity((12, 10, 30), seed=7, device="cpu")
    c = wave.gradient_velocity((12, 10, 30), seed=8, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 1500 * 0.95 - 1e-3 and float(a.max()) <= 4500 * 1.05 + 1e-3
    assert bool((a[:, :, 1:] > a[:, :, :-1]).all())   # faster with depth everywhere


@pytest.mark.parametrize("bad, match", [
    (dict(source=(20, 0, 0)), "outside the block"),
    (dict(backend="pallas"), "backend must be"),
    (dict(steps=-1), "steps must be"),
])
def test_bad_arguments_raise(bad, match):
    kw = dict(source=(1, 1, 1), backend="fused", steps=2)
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        wave.propagate_shot(_model((8, 8, 8)), kw["source"], RICKER, kw["steps"],
                            backend=kw["backend"])


def test_wrapper_refuses_aliased_fields():
    u = torch.zeros((6, 6, 6))
    c = torch.ones((6, 6, 6))
    with pytest.raises(ValueError, match="in place"):
        wave_kernel.wave_leapfrog(u, u, c, weights=wave.step_weights())
    with pytest.raises(ValueError, match="float32"):
        wave_kernel.wave_leapfrog(u, torch.zeros((6, 6, 6), dtype=torch.float64), c,
                                  weights=wave.step_weights())


def test_launcher_runs_on_the_cpu(tmp_path):
    from repro_torch.launch import wave as launch_wave

    out = launch_wave.main(["--device", "cpu", "--mesh", "16", "14", "20", "--steps", "6",
                            "--shots", "2", "--run-dir", str(tmp_path / "run")])
    assert len(out["shots"]) == 2 and not any(s["failed"] for s in out["shots"])
    assert (tmp_path / "run" / "manifest.json").is_file()
