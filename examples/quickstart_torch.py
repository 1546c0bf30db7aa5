"""Quickstart on the PyTorch port: solve a 7-point stencil system with
distributed mixed-precision BiCGStab, then refine it to f32 accuracy.  The
counterpart of ``examples/quickstart.py``, plus ``--device`` (the card
unless ``--device cpu``).

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --standalone --nproc-per-node 4 \\
        examples/quickstart_torch.py --device cpu        # a 2x2 fabric of gloo ranks

Under ``torchrun`` every rank solves its block of the global arrays (the
halo exchange and the dots' AllReduces run between the ranks) and rank 0
prints.
"""

import argparse

import torch

from repro_torch.core import bicgstab, dist, precision, stencil
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_for_devices


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = dist.init(device_type=args.device) if dist.launched() else resolve_device(args.device)
    say = print if dist.is_root() else (lambda *a, **k: None)

    # A convection-diffusion system (nonsymmetric, diagonally dominant) on a
    # 48 x 48 x 32 mesh, diagonally preconditioned to unit diagonal (paper §IV).
    shape = (48, 48, 32)
    coeffs = stencil.convection_diffusion(shape, peclet=5.0, device=dev)
    x_true = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(dev)
    b = stencil.rhs_for_solution(coeffs, x_true)

    # Map the mesh onto the ranks (Fig. 3) and solve in the paper's mixed
    # precision: bf16 storage/arithmetic, f32 reductions.
    mesh = make_mesh_for_devices()
    say(f"fabric: {mesh.shape} on {dev}")
    result = bicgstab.solve_distributed(mesh, coeffs, b.to(torch.bfloat16), tol=1e-7,
                                        maxiter=200, policy=precision.MIXED)
    say(f"converged={bool(result.converged)} in {int(result.iterations)} iters")
    err = float((result.x.float() - x_true).abs().max())
    say(f"max error vs manufactured solution (bf16 plateau): {err:.2e}")

    # Beyond the paper: iterative refinement recovers f32 accuracy while the
    # inner solver stays 16-bit (§VI-B made concrete).
    x, rels = bicgstab.solve_refined(coeffs, b, mesh=mesh, inner_policy=precision.MIXED)
    err = float((x - x_true).abs().max())
    say(f"after refinement: true-residual {float(rels[-1]):.2e}, max error {err:.2e}")
    dist.shutdown()


if __name__ == "__main__":
    main()
