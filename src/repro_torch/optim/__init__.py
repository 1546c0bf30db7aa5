"""Optimizers (plain PyTorch, no torch.optim): AdamW + cosine schedule +
global clipping, plus an int8 error-feedback gradient-compression wrapper
for the data-parallel axis."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState, adamw_init, adamw_update, cosine_lr, global_norm,
)
from repro_torch.optim.compress import compress_grads, decompress_grads  # noqa: F401
