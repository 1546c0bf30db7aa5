"""Device resolution and the numpy crossing (counterpart of ``repro/compat.py``).

The JAX package resolves *where a kernel runs* through its Pallas interpret
switch.  Here the device of the tensor decides: a CPU tensor takes a kernel's
plain PyTorch version, a CUDA tensor launches the CUDA kernel or raises.  So
what this module resolves is the device itself, and it never falls back from
CUDA to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch device an entry point runs on; ``None`` means ``cuda``.

    Raises when CUDA is asked for and absent: a caller that wants the CPU
    says so.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; ask for device='cpu' explicitly to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def tensor_from_numpy(a: np.ndarray, device: str | torch.device = "cpu") -> torch.Tensor:
    """A numpy array as a tensor on ``device``, bfloat16 included.

    numpy has no bfloat16 of its own; arrays that JAX hands out carry the
    ``ml_dtypes`` bfloat16 (dtype name ``bfloat16``), whose bits are
    reinterpreted here without rounding.
    """
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # e.g. a view of a JAX buffer: copy, never alias
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 widens to float32
    (exactly: every bfloat16 value is a float32 value)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work; a CPU device has none."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: str | torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
