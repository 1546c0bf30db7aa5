"""The plain reference against the port's plain path on the CPU, at tiny
meshes, on inputs the benchmark's own generators made.

The port runs its ``fused`` backend on CPU tensors, which takes each
kernel's plain PyTorch version; the reference imports nothing of the port.
"""

import math

import pytest
import torch

from perfbench import registry
from perfbench.reference import krylov, stencil
from perfbench.reference.operators import convection_diffusion
from perfbench.reference.precision import PRECISIONS

MANIFEST = registry.load_manifest()
CS1 = registry.load_config(MANIFEST, "cs1_star7")


def _system(config, traffic, seed=3, device="cpu"):
    return registry.system(config["system"]).System(config, traffic, seed, device)


def _traffic(mesh, iterations=6):
    return dict(mesh=list(mesh), solver="bicgstab", iterations=iterations, pool=2,
                check_sample=2)


def _port_coeffs(fields):
    from repro_torch.core.stencil import StencilCoeffs

    return StencilCoeffs(dict(fields))


def test_fields_equal_the_ports_generators():
    from repro_torch.core import stencil as port

    shape = (6, 5, 4)
    mine = convection_diffusion.fields(shape, CS1["operator"]["params"], "cpu")
    theirs = port.convection_diffusion(shape, device="cpu").diags
    assert list(mine) == list(theirs)
    assert all(torch.equal(mine[n], theirs[n]) for n in mine)


def test_apply_equals_the_ports_spmv():
    """The reference SpMV, each product and sum rounded to bf16 in canonical
    order, equals the port's plain SpMV bit for bit."""
    from repro_torch.core.operator import fused_operator
    from repro_torch.core.precision import MIXED

    shape = (9, 10, 11)
    op = registry.operator(CS1["operator"]["kind"])
    fields = op.fields(shape, CS1["operator"]["params"], "cpu")
    offs = op.offsets(CS1["operator"]["params"])
    gen = torch.Generator().manual_seed(7)
    v = torch.randn(shape, generator=gen).to(torch.bfloat16)
    prec = PRECISIONS["bf16_mixed"]
    mine = stencil.apply({n: prec.store(f) for n, f in fields.items()}, offs, v, prec.compute)
    theirs = fused_operator(_port_coeffs(fields), policy=MIXED).apply(v)
    assert torch.equal(mine, theirs)


def test_rhs_is_the_f32_apply_stored_in_bf16():
    from repro_torch.core.stencil import apply_ref

    sut = _system(CS1, _traffic((8, 8, 8)), seed=2**31 + 11)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 8, 8), generator=gen)
    mine = stencil.apply_f32(sut.fields, sut.offsets, x)
    theirs = apply_ref(_port_coeffs(sut.fields), x)
    assert torch.allclose(mine, theirs, rtol=1e-6, atol=1e-6)
    assert sut.pool[0].dtype == torch.bfloat16 and sut.pool[0].shape == (8, 8, 8)


def test_pool_is_made_from_the_seed():
    a = _system(CS1, _traffic((8, 8, 8)), seed=2**31 + 5)
    b = _system(CS1, _traffic((8, 8, 8)), seed=2**31 + 5)
    c = _system(CS1, _traffic((8, 8, 8)), seed=2**31 + 6)
    assert all(torch.equal(x, y) for x, y in zip(a.pool, b.pool))
    assert not torch.equal(a.pool[0], c.pool[0]) and not torch.equal(a.pool[0], a.pool[1])
    assert a.checked == b.checked


@pytest.mark.parametrize("mesh", [(12, 12, 16), (10, 10, 10)], ids=str)
def test_reference_solve_holds_the_ports(mesh):
    """The port's plain solve and the reference's, both in bf16_mixed, on the
    benchmark's inputs: both converge, and the numbers a run compares stay
    far below the control's readings at these sizes."""
    traffic = _traffic(mesh)
    sut = _system(CS1, traffic)
    records = [sut.step(k) for k in sut.checked]
    assert not any(r.failed for r in records)
    nums = sut.numbers(sut.kept)
    assert nums["x_gap"] < 0.03 and nums["x_gap_max"] < 0.06
    assert nums["res_ratio"] < 1.5
    assert all(r.iterations == 6 and r.rel_residual < 0.1 for r in records)


def test_f32_reference_follows_the_port_closely():
    """In f32 the two solvers agree to a few ulps of the iteration's scalars:
    the same iteration count and x within 1e-4."""
    from repro_torch.core import bicgstab
    from repro_torch.core.precision import F32
    from repro_torch.launch.mesh import make_mesh_for_devices

    sut = _system(CS1, _traffic((12, 12, 10)))
    b = sut.pool[0].float()
    port = bicgstab.solve_distributed(make_mesh_for_devices(), _port_coeffs(sut.fields), b,
                                      tol=1e-5, maxiter=100, policy=F32, solver="bicgstab",
                                      backend="fused")
    prec = PRECISIONS["f32"]
    mine = krylov.bicgstab(lambda v: stencil.apply_f32(sut.fields, sut.offsets, v), b,
                           tol=1e-5, maxiter=100, prec=prec)
    assert mine.converged and bool(port.converged)
    assert mine.iterations == int(port.iterations)
    gap = float(torch.linalg.vector_norm(mine.x - port.x) / torch.linalg.vector_norm(port.x))
    assert gap < 1e-4


@pytest.mark.card
def test_reference_apply_on_the_card_equals_the_cpu(card):
    shape = (33, 20, 17)
    offs = convection_diffusion.offsets(CS1["operator"]["params"])
    fields = convection_diffusion.fields(shape, CS1["operator"]["params"], "cpu")
    v = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    cpu = stencil.apply({n: f.to(torch.bfloat16) for n, f in fields.items()}, offs, v,
                        torch.bfloat16)
    gpu = stencil.apply({n: f.to(card, torch.bfloat16) for n, f in fields.items()}, offs,
                        v.to(card), torch.bfloat16)
    assert torch.equal(cpu, gpu.cpu())
    assert math.isfinite(float(gpu.float().sum()))
