from repro_torch.kernels.fused_iter.ops import (  # noqa: F401
    dot_mixed, update_p, update_q_dots, update_xr_dots,
)
