"""Deprecation shim: the 7-point kernel names, re-exported.

Counterpart of ``repro/kernels/stencil7.py``.  The 7-point SpMV with its
dot epilogue lives, with the rest of the stencil family, in
:mod:`repro_torch.kernels.stencil_nd`; this module re-exports the legacy
names ``ORDER``, ``stencil7_dot`` and ``stencil7_two_dots`` from
``kernels/stencil_nd/fused.py`` and warns on import.  It adds no kernel.
New code should import from ``kernels/stencil_nd`` directly.
"""

from __future__ import annotations

import warnings

warnings.warn(
    "repro_torch.kernels.stencil7 is deprecated: the 7-point kernel lives, "
    "shape-parameterized, in repro_torch.kernels.stencil_nd — import from there. "
    "This shim re-exports the legacy names and will be removed.",
    DeprecationWarning, stacklevel=2)

from repro_torch.kernels.stencil_nd.fused import (  # noqa: E402, F401  (re-exported API)
    ORDER,
    stencil7_dot,
    stencil7_two_dots,
)
