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

    return stencil_kernel.launches, fused_iter_kernel.launches, stencil7_dot_kernel.launches


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel name."""
    return {name: n for counts in _counters() for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _counters():
        for name in counts:
            counts[name] = 0
