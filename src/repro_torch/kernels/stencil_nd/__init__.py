from repro_torch.kernels.stencil_nd.ops import (  # noqa: F401
    fused_local_apply,
    ring_patch_apply,
    stencil_apply,
)
from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref, stencil_nd_ref  # noqa: F401
