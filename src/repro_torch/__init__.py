"""repro_torch: the wafer-scale stencil solver on PyTorch and CUDA (NVIDIA H100).

A port of :mod:`repro` (JAX on TPU) that mirrors its module tree, so every
module here has one JAX counterpart it is tested against.  The plain tensor
code is PyTorch; every kernel the JAX package wrote in Pallas for the TPU is
a CUDA C++ kernel written for Hopper (``kernels/csrc/``), built with ``nvcc``
on first use.  This package imports neither ``jax`` nor ``repro``.

Entry points run on the card unless the caller asks for the CPU; on a CPU
tensor every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
