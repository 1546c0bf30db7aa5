"""Port parity for core/stencil: the spec registry, the generators,
``from_numpy``, ``apply_ref`` and ``to_dense`` against the JAX package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_port import assert_bitwise, carry_coeffs, to_np, to_t  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.core import stencil as jst  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import stencil as tst  # noqa: E402

SPECS = ["star7", "star13", "star25", "box27"]


@pytest.mark.parametrize("name", SPECS)
def test_spec_registry_matches(name):
    js, ts = jst.get_spec(name), tst.get_spec(name)
    assert ts.offsets == js.offsets
    assert ts.names == js.names
    assert (ts.radius, ts.pattern, ts.n_points) == (js.radius, js.pattern, js.n_points)
    assert tst.spec_of(ts.names) == ts


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gen", ["poisson_star7", "poisson_box27", "convdiff",
                                 "seismic_r2", "seismic_r4"])
def test_deterministic_generators_bitwise(gen, dtype):
    shape = (4, 3, 5)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    if gen.startswith("poisson"):
        spec = "star7" if gen.endswith("star7") else "box27"
        cj = jst.poisson(shape, jd, spec=jst.get_spec(spec))
        ct = tst.poisson(shape, td, spec=tst.get_spec(spec), device="cpu")
    elif gen == "convdiff":
        cj, ct = jst.convection_diffusion(shape, jd), tst.convection_diffusion(shape, td,
                                                                         device="cpu")
    else:
        r = int(gen[-1])
        cj, ct = jst.high_order_star(shape, r, jd), tst.high_order_star(shape, r, td, device="cpu")
    assert ct.names == cj.names
    for n in cj.names:
        assert ct.diags[n].dtype == td
        assert_bitwise(ct.diags[n], cj.diags[n])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_from_numpy_keeps_bits(dtype):
    cj = jst.heterogeneous_poisson(jax.random.PRNGKey(3), (4, 5, 3), dtype)
    ct = carry_coeffs(cj)
    assert ct.names == cj.names and ct.shape == cj.shape
    for n in cj.names:
        assert_bitwise(ct.diags[n], cj.diags[n])
    assert_bitwise(ct.diag, cj.diag)


@pytest.mark.parametrize("policy", ["f32", "bf16_mixed"])
@pytest.mark.parametrize("name", SPECS)
def test_apply_ref_matches_jax(name, policy):
    """f32: rtol/atol 1e-6 (XLA on the CPU contracts a*b+c into FMAs, torch
    eager does not: 1-ulp differences).  bf16: one bf16 ulp (XLA's default
    excess precision may skip a bf16 rounding inside the fused expression;
    the strict mode agrees bitwise, see test_torch_kernel_fused_iter)."""
    shape = (6, 5, 8)
    spec = jst.get_spec(name)
    cj = jst.random_nonsymmetric(jax.random.PRNGKey(0), shape, spec=spec)
    v = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    uj = jst.apply_ref(cj, jnp.asarray(v), policy=jprec.get_policy(policy))
    ut = tst.apply_ref(carry_coeffs(cj), to_t(v), policy=tprec.get_policy(policy))
    tol = 1e-6 if policy == "f32" else 8e-3
    np.testing.assert_allclose(to_np(ut), to_np(uj), rtol=tol, atol=tol)


def test_apply_ref_raw_diag_and_batch_axis():
    shape = (5, 4, 6)
    cj = jst.heterogeneous_poisson(jax.random.PRNGKey(2), shape)
    v = np.random.default_rng(3).standard_normal((2,) + shape).astype(np.float32)
    uj = jst.apply_ref(cj, jnp.asarray(v))
    ut = tst.apply_ref(carry_coeffs(cj), to_t(v))
    np.testing.assert_allclose(to_np(ut), to_np(uj), rtol=1e-6, atol=1e-5)
    # B=1 of the batch equals the unbatched apply bitwise
    assert_bitwise(tst.apply_ref(carry_coeffs(cj), to_t(v[0])), ut[0])


@pytest.mark.parametrize("name", ["star7", "box27"])
def test_to_dense_matches_jax(name):
    shape = (4, 3, 5)
    cj = jst.random_nonsymmetric(jax.random.PRNGKey(5), shape, spec=jst.get_spec(name))
    np.testing.assert_array_equal(tst.to_dense(carry_coeffs(cj)), jst.to_dense(cj))
    # and the dense matrix is the apply
    v = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    dense = tst.to_dense(carry_coeffs(cj)) @ v.astype(np.float64).ravel()
    np.testing.assert_allclose(to_np(tst.apply_ref(carry_coeffs(cj), to_t(v))).ravel(),
                               dense, rtol=1e-5, atol=1e-5)


def test_rhs_for_solution_matches_jax():
    shape = (6, 6, 4)
    cj = jst.convection_diffusion(shape)
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    bj = jst.rhs_for_solution(cj, jnp.asarray(x))
    bt = tst.rhs_for_solution(tst.convection_diffusion(shape, device="cpu"), to_t(x))
    np.testing.assert_allclose(to_np(bt), to_np(bj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["star7", "box27"])
def test_torch_random_generators_keep_their_contract(name):
    """The torch.Generator twins draw other numbers than jax.random but keep
    the generators' structure: row off-diagonal mass 1/dominance for
    random_nonsymmetric, row-sum diagonal and symmetric face couplings for
    heterogeneous_poisson."""
    shape = (5, 4, 6)
    spec = tst.get_spec(name)
    g = torch.Generator().manual_seed(0)
    cf = tst.random_nonsymmetric(g, shape, spec=spec, dominance=1.25)
    mass = sum(c.abs().double() for c in cf.diags.values())
    np.testing.assert_allclose(mass.numpy(), 1 / 1.25, rtol=1e-6)
    hp = tst.heterogeneous_poisson(torch.Generator().manual_seed(1), shape, spec=spec)
    np.testing.assert_allclose(hp.diag.numpy(), -sum(c for c in hp.diags.values()).numpy(),
                               rtol=1e-5)
    A = tst.to_dense(hp)
    np.testing.assert_allclose(A, A.T, rtol=0, atol=1e-6 * np.abs(A).max())
    # same seed, same system
    again = tst.random_nonsymmetric(torch.Generator().manual_seed(0), shape, spec=spec)
    for n in cf.names:
        assert torch.equal(cf.diags[n], again.diags[n])


@pytest.mark.parametrize("make", [lambda: tst.poisson((3, 3, 3)),
                                  lambda: tst.convection_diffusion((3, 3, 3)),
                                  lambda: tst.high_order_star((9, 9, 9), 4)],
                         ids=["poisson", "convdiff", "seismic"])
def test_deterministic_generators_need_a_device(make):
    """The caller names the device: a generator never picks the CPU on its own."""
    with pytest.raises(TypeError, match="device"):
        make()
