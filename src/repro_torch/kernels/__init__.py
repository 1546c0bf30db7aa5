"""Hand-written CUDA kernels for Hopper (``csrc/``), each with a plain PyTorch
version beside it and a launch counter.

The counters let a run show that its main path went through the kernels:
reset them, drive the path, read them.
"""

from __future__ import annotations


def _counters() -> tuple[dict[str, int], ...]:
    from repro_torch.kernels.fused_iter import kernel as fused_iter_kernel
    from repro_torch.kernels.stencil_nd import fused as stencil7_dot_kernel
    from repro_torch.kernels.stencil_nd import kernel as stencil_kernel
    from repro_torch.kernels.wave import kernel as wave_kernel

    return (stencil_kernel.launches, fused_iter_kernel.launches, stencil7_dot_kernel.launches,
            wave_kernel.launches)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel name."""
    return {name: n for counts in _counters() for name, n in counts.items()}


def element_wise_launch_counts() -> dict[str, int]:
    """Launches so far of the fused group passes that took their element-wise
    form (n not a whole number of 16-B groups, or an operand off a 16-B
    boundary), by kernel name; a subset of :func:`launch_counts`' launches."""
    from repro_torch.kernels.fused_iter import kernel as fused_iter_kernel

    return dict(fused_iter_kernel.element_wise_launches)


def rhs_counts() -> dict[str, int]:
    """Right-hand sides served so far by the batched stencil wrappers'
    launches (K1b and its axpy form), by wrapper name; over its
    :func:`launch_counts` entry, the right-hand sides one launch served."""
    from repro_torch.kernels.stencil_nd import kernel as stencil_kernel

    return dict(stencil_kernel.rhs)


def reset_launch_counts() -> None:
    """Zero every launch counter, the element-wise and right-hand-side ones
    included."""
    from repro_torch.kernels.fused_iter import kernel as fused_iter_kernel
    from repro_torch.kernels.stencil_nd import kernel as stencil_kernel

    for counts in (*_counters(), fused_iter_kernel.element_wise_launches, stencil_kernel.rhs):
        for name in counts:
            counts[name] = 0
